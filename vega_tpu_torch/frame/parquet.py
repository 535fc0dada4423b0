"""Parquet helpers of the frame layer: the port's own copy of the
parquet half of vega_tpu/io/readers.py (that module imports the host
tier's RDD classes, so the port cannot import it).

File discovery with a crisp error, row-group pruning by footer
statistics, the batch reader with column pruning and predicate pushdown
applied inside it, and the cached footer metadata the planner reads
(schema, row counts, string columns, null counts, min / max). pyarrow is
imported inside the functions: the port imports, and runs frames over
in-memory columns, on a machine without it."""

from __future__ import annotations

import glob as globlib
import os
from typing import List, Optional

from vega_tpu_torch.errors import VegaError


def _discover(path: str) -> List[str]:
    """Directory walk / glob expansion (vega_tpu/io/readers.py:_discover)."""
    if os.path.isdir(path):
        files = []
        for root, _dirs, names in os.walk(path):
            for name in sorted(names):
                if not name.startswith("."):
                    files.append(os.path.join(root, name))
        return sorted(files)
    matches = sorted(globlib.glob(path))
    if not matches and os.path.exists(path):
        matches = [path]
    return matches


# Predicate-pushdown conjunct operators (ParquetColumnReader.predicate):
# each conjunct is a (column, op, literal) triple. Row groups whose
# min/max statistics cannot satisfy a conjunct are skipped whole; rows
# surviving the row-group pass are mask-filtered per batch — either way
# the pruned rows never leave the reader.
_PRED_OPS = {
    "==": lambda c, v: c == v,
    "!=": lambda c, v: c != v,
    "<": lambda c, v: c < v,
    "<=": lambda c, v: c <= v,
    ">": lambda c, v: c > v,
    ">=": lambda c, v: c >= v,
}


def discover_parquet_files(path: str) -> List[str]:
    """Parquet file discovery with a crisp contract: expanding a directory
    or glob keeps only .parquet/.pq files and REFUSES loudly when none
    match (feeding an arbitrary matched file to pyarrow produces an
    undecipherable downstream stack trace); a single explicitly-named
    existing file is taken as-is (explicit path == user intent, whatever
    the extension)."""
    files = _discover(path)
    if not files:
        raise VegaError(
            f"parquet read: path {path!r} matches no files"
        )
    if len(files) == 1 and files[0] == path and os.path.isfile(path):
        return files
    matched = [f for f in files if f.endswith((".parquet", ".pq"))]
    if not matched:
        raise VegaError(
            f"parquet read: no .parquet/.pq files under {path!r} — the "
            f"{len(files)} file(s) found there (e.g. "
            f"{os.path.basename(files[0])!r}) are not parquet; pass the "
            "file explicitly if the extension is just unconventional"
        )
    return matched


def assign_files_to_partitions(files: List[str],
                               num_partitions: int) -> List[List[str]]:
    """Size-balanced greedy packing of files into partitions: the biggest
    file to the least-loaded partition (the host tier's file splits)."""
    import heapq

    num_partitions = max(1, min(num_partitions, max(len(files), 1)))
    sized = sorted(((os.path.getsize(f), f) for f in files), reverse=True)
    heap = [(0, i, []) for i in range(num_partitions)]
    heapq.heapify(heap)
    for size, f in sized:
        load, i, bucket = heapq.heappop(heap)
        bucket.append(f)
        heapq.heappush(heap, (load + size, i, bucket))
    buckets = [[] for _ in range(num_partitions)]
    for _load, i, bucket in heap:
        buckets[i] = bucket
    return [b for b in buckets if b] or [[]]


def _row_group_may_match(meta_rg, col_index: dict, predicate) -> bool:
    """False only when the row group's column statistics PROVE no row can
    satisfy the conjunct — missing/partial statistics keep the group."""
    for name, op, lit in predicate:
        idx = col_index.get(name)
        if idx is None:
            continue
        col = meta_rg.column(idx)
        stats = col.statistics
        if stats is None or not stats.has_min_max:
            continue
        lo, hi = stats.min, stats.max
        try:
            if op == "==" and (lit < lo or lit > hi):
                return False
            if op == "<" and lo >= lit:
                return False
            if op == "<=" and lo > lit:
                return False
            if op == ">" and hi <= lit:
                return False
            if op == ">=" and hi < lit:
                return False
        except TypeError:
            continue  # incomparable stats (e.g. bytes vs int): keep
    return True


def iter_parquet_batches(paths: List[str], columns: Optional[List[str]],
                         predicate=None, batch_rows: int = 1 << 20,
                         arrow_columns=None):
    """Yield {name: numpy column} dicts with column pruning AND predicate
    pushdown applied inside the reader. Columns the query never names and
    rows no conjunct can accept never leave the file layer.

    Columns named in `arrow_columns` skip the numpy pivot: each is
    dictionary-encoded ON THE ARROW SIDE (string columns ride the file's
    dictionary pages straight through — no per-row Python objects) and
    yielded as a `(codes int32, values '<U') numpy pair` instead of a
    flat array. Predicate columns are excluded — the conjunct mask
    evaluates on numpy values."""
    import numpy as np
    import pyarrow.parquet as pq

    predicate = list(predicate or ())
    arrow_columns = set(arrow_columns or ()) - {nm for nm, _o, _v
                                               in predicate}
    # Predicate columns must be read to evaluate the mask even when the
    # query output prunes them; they are dropped again after filtering.
    read_cols = columns
    if columns is not None and predicate:
        extra = [nm for nm, _op, _v in predicate if nm not in columns]
        read_cols = list(columns) + sorted(set(extra))
    for path in paths:
        pf = pq.ParquetFile(path)
        names = pf.schema_arrow.names
        col_index = {nm: i for i, nm in enumerate(names)}
        if predicate:
            groups = [g for g in range(pf.metadata.num_row_groups)
                      if _row_group_may_match(pf.metadata.row_group(g),
                                              col_index, predicate)]
            if not groups:
                continue
        else:
            groups = None  # all
        for batch in pf.iter_batches(batch_size=batch_rows,
                                     columns=read_cols, row_groups=groups):
            block = {}
            for i, name in enumerate(batch.schema.names):
                col = batch.column(i)
                if name in arrow_columns:
                    enc = col.dictionary_encode()
                    # vegalint: ignore[VG013] — the file reader, run when a source partition is computed (io/readers.py, physical.py's parquet source), never at plan build; vega_tpu keeps it in io/readers.py
                    idx = enc.indices.to_numpy(zero_copy_only=False)
                    codes = np.asarray(idx).astype(np.int32, copy=False)
                    vals = np.asarray(enc.dictionary).astype(np.str_)
                    block[name] = (codes, vals)
                else:
                    # vegalint: ignore[VG013] — the file reader, run when a source partition is computed, never at plan build (as above)
                    block[name] = col.to_numpy(zero_copy_only=False)
            if predicate:
                mask = None
                for nm, op, lit in predicate:
                    m = _PRED_OPS[op](block[nm], lit)
                    mask = m if mask is None else (mask & m)
                if mask is not None and not np.all(mask):
                    block = {
                        nm: ((c[0][mask], c[1]) if nm in arrow_columns
                             else c[mask])
                        for nm, c in block.items()
                    }
            if columns is not None:
                block = {nm: block[nm] for nm in columns}
            yield block


# Parquet METADATA cache, keyed on (abspath, mtime_ns, size): one frame
# compile consults schema, row counts and column statistics several times
# (entry-point schema, planner schema, size estimate, int32-fit proofs —
# and again on every action, since frames recompile per action), and each
# consult used to re-open the file's footer. One footer read per file
# version serves them all. Bounded: pruned crudely once it grows past
# _META_CACHE_MAX (fixture churn in tests).
_META_CACHE: dict = {}
_META_CACHE_MAX = 1024


def _file_meta(path: str) -> dict:
    import pyarrow.parquet as pq

    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    meta = _META_CACHE.get(key)
    if meta is not None:
        return meta
    pf = pq.ParquetFile(path)
    m = pf.metadata
    idx = {m.schema.column(i).name: i for i in range(m.num_columns)}
    minmax = {}
    for name, i in idx.items():
        lo = hi = None
        complete = True
        for g in range(m.num_row_groups):
            stats = m.row_group(g).column(i).statistics
            if stats is None or not stats.has_min_max:
                complete = False
                break
            try:
                lo = stats.min if lo is None else min(lo, stats.min)
                hi = stats.max if hi is None else max(hi, stats.max)
            except TypeError:  # incomparable stats values
                complete = False
                break
        minmax[name] = (lo, hi) if complete and lo is not None else None
    import pyarrow as pa

    nulls = {}
    for name, i in idx.items():
        total = 0
        for g in range(m.num_row_groups):
            stats = m.row_group(g).column(i).statistics
            if stats is None or stats.null_count is None:
                total = None
                break
            total += stats.null_count
        nulls[name] = total
    meta = {
        "schema": {f.name: f.type.to_pandas_dtype()
                   for f in pf.schema_arrow},
        "strings": {f.name for f in pf.schema_arrow
                    if pa.types.is_string(f.type)
                    or pa.types.is_large_string(f.type)},
        "num_rows": m.num_rows,
        "minmax": minmax,
        "nulls": nulls,
    }
    if len(_META_CACHE) >= _META_CACHE_MAX:
        _META_CACHE.clear()
    _META_CACHE[key] = meta
    return meta


def parquet_schema(path: str) -> dict:
    """{column: numpy dtype} from file metadata only (no data read) — the
    frame planner's schema source."""
    return dict(_file_meta(discover_parquet_files(path)[0])["schema"])


def parquet_num_rows(path: str) -> int:
    """Total rows across the path's files, from metadata only (the frame
    planner's exchange-sizing estimate)."""
    return sum(_file_meta(f)["num_rows"]
               for f in discover_parquet_files(path))


def parquet_string_columns(path: str) -> set:
    """Column names with an arrow string/large_string type, from metadata
    only — the frame planner's dictionary-encoding eligibility source
    (a pandas-dtype `object` alone cannot distinguish string columns
    from arbitrary object columns)."""
    out: set = set()
    for f in discover_parquet_files(path):
        out |= _file_meta(f)["strings"]
    return out


def parquet_column_nulls(path: str, column: str):
    """Total null count across the path's files from statistics, or None
    when any row group lacks them. Metadata only — the dictionary-encoded
    device path requires a proven null-free string column (codes have no
    null slot); unknown counts keep the column on the host tier."""
    total = 0
    for f in discover_parquet_files(path):
        n = _file_meta(f)["nulls"].get(column)
        if n is None:
            return None
        total += n
    return total


def parquet_column_minmax(path: str, column: str):
    """(min, max) over every row group's statistics, or None when any
    group lacks them. Metadata only — lets the frame planner prove an
    int64 column fits int32 without touching data."""
    lo = hi = None
    for f in discover_parquet_files(path):
        mm = _file_meta(f)["minmax"].get(column)
        if mm is None:
            return None
        lo = mm[0] if lo is None else min(lo, mm[0])
        hi = mm[1] if hi is None else max(hi, mm[1])
    return None if lo is None else (lo, hi)
