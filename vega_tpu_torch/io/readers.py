"""File ingest: the port's copy of vega_tpu/io/readers.py's sources.

A reader config's make_reader(ctx) gives a host RDD (rdd/) with one
partition per group of whole files: _discover walks a directory (hidden
files left out) or expands a glob, and assign_files_to_partitions packs
the files, the largest first, into the least-loaded of num_partitions
groups. A file is never split. Each partition reads its files in order:
LocalFsReaderConfig gives each file's bytes, WholeFileReaderConfig
(path, bytes), TextFileReaderConfig one str per line with its "\\n"
stripped (decoded with errors="replace"). ParquetColumnReader gives the
{name: numpy column} blocks of frame/parquet.py's batch reader (pyarrow,
imported when a partition is read), and rows() one tuple per row.

host= pins the source to a host, as the reference's does: its
preferred_locations name it and is_pinned is set. The port runs every
partition in this process, so the pin changes nothing else.

Discovery, packing and the parquet batch reader are frame/parquet.py's
(one copy in the port).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

from vega_tpu_torch.frame.parquet import (_discover,
                                          assign_files_to_partitions,
                                          discover_parquet_files,
                                          iter_parquet_batches)
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.split import Split

__all__ = ["LocalFsReaderConfig", "ParquetColumnReader",
           "ParquetReaderConfig", "TextFileReaderConfig",
           "WholeFileReaderConfig", "_discover",
           "assign_files_to_partitions"]


class _FileListRDD(RDD):
    """Source RDD over pre-assigned file groups; one partition per
    group."""

    def __init__(self, ctx, groups: List[List[str]],
                 read_group: Callable[[List[str]], Iterator],
                 host: Optional[str] = None):
        super().__init__(ctx)
        self._groups = groups
        self._read_group = read_group
        self._host = host
        if host is not None:
            self._pinned = True

    @property
    def num_partitions(self) -> int:
        return len(self._groups)

    def splits(self) -> List[Split]:
        return [Split(i, payload=g) for i, g in enumerate(self._groups)]

    def preferred_locations(self, split: Split) -> List[str]:
        return [self._host] if self._host else []

    def compute(self, split: Split, task_context=None) -> Iterator:
        return self._read_group(split.payload or self._groups[split.index])


def _read_bytes(files: List[str]) -> Iterator[bytes]:
    for f in files:
        with open(f, "rb") as fh:
            yield fh.read()


def _read_path_bytes(files: List[str]):
    for f in files:
        with open(f, "rb") as fh:
            yield (f, fh.read())


def _read_lines(files: List[str]) -> Iterator[str]:
    for f in files:
        with open(f, "r", errors="replace") as fh:
            for line in fh:
                yield line.rstrip("\n")


class LocalFsReaderConfig:
    """Raw file bytes, one item per file."""

    _read_group = staticmethod(_read_bytes)

    def __init__(self, path: str, num_partitions: int = 4,
                 host: Optional[str] = None):
        self.path = path
        self.num_partitions = num_partitions
        self.host = host

    def make_reader(self, ctx) -> RDD:
        groups = assign_files_to_partitions(_discover(self.path),
                                            self.num_partitions)
        return _FileListRDD(ctx, groups, self._read_group, self.host)


class WholeFileReaderConfig(LocalFsReaderConfig):
    """(path, bytes) per file."""

    _read_group = staticmethod(_read_path_bytes)


class TextFileReaderConfig(LocalFsReaderConfig):
    """One item per line, like Spark's textFile."""

    _read_group = staticmethod(_read_lines)


class ParquetColumnReader:
    """Columnar parquet ingest: one {name: numpy column} dict per batch.
    columns prunes at the file layer; predicate ([(column, op, literal),
    ...] conjuncts, op in == != < <= > >=) skips row groups by their
    statistics and masks the rest."""

    def __init__(self, path: str, columns: Optional[List[str]] = None,
                 num_partitions: int = 4, batch_rows: int = 1 << 20,
                 host: Optional[str] = None, predicate=None):
        self.path = path
        self.columns = columns
        self.num_partitions = num_partitions
        self.batch_rows = batch_rows
        self.host = host
        self.predicate = list(predicate or ())

    def make_reader(self, ctx) -> RDD:
        groups = assign_files_to_partitions(
            discover_parquet_files(self.path), self.num_partitions)
        columns, predicate = self.columns, self.predicate
        batch_rows = self.batch_rows

        def read_group(paths: List[str]):
            yield from iter_parquet_batches(paths, columns, predicate,
                                            batch_rows)

        return _FileListRDD(ctx, groups, read_group, self.host)

    def rows(self, ctx) -> RDD:
        """Row view: one tuple per row (host tier)."""

        def to_rows(block: dict):
            cols = list(block.values())
            n = len(cols[0]) if cols else 0
            for i in range(n):
                yield tuple(c[i] for c in cols)

        return self.make_reader(ctx).flat_map(to_rows)


# the reference's historical name (same class)
ParquetReaderConfig = ParquetColumnReader
