"""Parquet data source.

Parity surface: reference crates/query-storage/src/parquet.rs:8-39
(ParquetRecordBatchReaderBuilder full-file read).
"""

from __future__ import annotations

from typing import Optional

import pyarrow.parquet as pq

from query_engine_tpu_torch.core.errors import StorageError
from query_engine_tpu_torch.core.schema import Schema
from query_engine_tpu_torch.columnar.batch import ColumnBatch


class ParquetDataSource:
    def __init__(self, path: str):
        self.path = path
        self._batch: Optional[ColumnBatch] = None
        self._schema: Optional[Schema] = None

    def _load(self) -> ColumnBatch:
        if self._batch is None:
            try:
                table = pq.read_table(self.path)
            except (OSError, Exception) as e:  # pyarrow raises ArrowInvalid etc.
                if type(e).__module__.startswith("pyarrow") or isinstance(e, OSError):
                    raise StorageError(f"cannot read Parquet '{self.path}': {e}")
                raise
            self._batch = ColumnBatch.from_arrow(table)
            self._schema = self._batch.schema
        return self._batch

    def scan(self) -> ColumnBatch:
        return self._load()

    def schema(self) -> Schema:
        self._load()
        return self._schema
