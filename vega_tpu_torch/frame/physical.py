"""Frame physical building blocks: the lazy device sources (the port's
copy of the device half of vega_tpu/frame/physical.py).

Plan compilation builds the source node and checks the dtypes; the first
block() reads the file or coerces the arrays and shards them onto the
Context's device (planning itself never touches data or the device).

Dtype contract at the device boundary (the reference's, the same degrade
block.from_numpy applies): int64 / uint64 / uint32 columns whose values
fit int32 narrow to int32, and the others take the wide int64 pair
(block.encode_i64: <name> the high word, <name>.lo the biased low word),
where the reference compiles the plan on its host tier; float64 narrows
to float32; bool widens to int32; strings become int32 dictionary codes
plus a sorted host dictionary (dict_encoding.py). Anything else (object
columns of anything but strings, uint64 beyond int64) raises VegaError
when the plan compiles: the reference compiles such a plan on its host
tier, which the port does not have."""

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
    a string column, or "int64?" when a value range decides between int32
    and the wide pair),
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
    CHECK only (dtype kind, the int64 range check, the all-str object
    scan), no copy; the astype / encode runs at materialization. An
    integer column beyond int32 is "wide"."""
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
        kind = "int32"
        if len(col) and (col.min() < info.min or col.max() > info.max):
            if col.dtype == np.uint64 and col.max() > np.uint64(2**63 - 1):
                raise no_device_lowering(
                    f"column {name!r} holds uint64 values beyond int64")
            kind = "wide"
    return kind, False


def _host_column(src: np.ndarray, dtype: str, bn: str, out: dict) -> None:
    """One non-string host column in its device form under block name bn:
    the astype, or for "wide" the (bn, bn.lo) words of its int64
    values."""
    if dtype == "wide":
        if src.dtype == np.uint64 and len(src) and \
                src.max() > np.uint64(2**63 - 1):
            raise VegaError(f"column {bn!r} holds uint64 values beyond "
                            "int64, which no device column holds")
        out[bn], out[block_lib.lo_of(bn)] = block_lib.encode_i64(
            src.astype(np.int64))
    else:
        out[bn] = src.astype(dtype, copy=False)


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
        out = []
        for _fn, bn in self._names:
            if self._dtypes[bn] == "wide":
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
                _host_column(np.asarray(self._data[fn]), self._dtypes[bn],
                             bn, cols)
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
                        dtypes: Dict[str, np.dtype]) -> _ParquetSource:
    """Lazy source over a parquet path with pruning and predicate pushdown
    applied inside the reader. Compile time reads footers only (schema,
    min / max and null statistics); the files are read at the first
    materialization."""
    string_cols = parquet_lib.parquet_string_columns(path)
    for nm in sorted({nm for nm, _op, _lit in predicate} & string_cols):
        # a pushed-down conjunct compares the reader's values, where a null
        # has no order
        nulls = parquet_lib.parquet_column_nulls(path, nm)
        if nulls is None or nulls > 0:
            raise no_device_lowering(
                f"parquet string column {nm!r} has nulls (or no "
                "null-count statistics) under a pushed-down predicate")
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
            # int32 where the statistics prove it fits; otherwise (missing
            # statistics or out of range) the wide pair, which holds any
            # int64 (a uint64 beyond int64 raises when it is read)
            mm = parquet_lib.parquet_column_minmax(path, fn)
            info = np.iinfo(np.int32)
            kind = ("wide" if mm is None or mm[0] < info.min
                    or mm[1] > info.max else "int32")
        out_dtypes[bn] = kind
    files = parquet_lib.discover_parquet_files(path)
    return _ParquetSource(ctx, files, columns, predicate, names, out_dtypes,
                          dict_bns, dtypes)
