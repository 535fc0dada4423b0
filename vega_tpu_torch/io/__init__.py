"""File sources of the host RDD layer: the port's copy of vega_tpu/io."""

from vega_tpu_torch.io.readers import (
    LocalFsReaderConfig,
    ParquetColumnReader,
    ParquetReaderConfig,
    TextFileReaderConfig,
    WholeFileReaderConfig,
)

__all__ = [
    "LocalFsReaderConfig",
    "ParquetColumnReader",
    "ParquetReaderConfig",
    "TextFileReaderConfig",
    "WholeFileReaderConfig",
]
