"""In-memory data source with index hooks.

Parity surface: reference crates/query-storage/src/memory.rs:16-313 —
batch store + per-table IndexManager: create/drop B-Tree & Hash indexes,
build from data with global row ids (:124-141), index_lookup /
index_range_scan -> fetch_rows via take (:196-269), append keeps indexes
updated (:277-302).

The stored batch is never written in place: DML replaces it (`replace`,
`append`), so a transaction's snapshot can hold the old one by reference.
An index is built from whole key planes at once (`Index.bulk_load_columns`:
the native indexes encode every key in numpy and take them in one call),
not one Python insert a row.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from query_engine_tpu_torch.core.errors import StorageError
from query_engine_tpu_torch.core.schema import Schema
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.index.manager import IndexManager


class MemoryDataSource:
    def __init__(self, batch: Optional[ColumnBatch] = None,
                 schema: Optional[Schema] = None, name: str = "",
                 device="cpu"):
        """A table from `batch`, or an empty one of `schema` whose planes
        are made on `device`."""
        if batch is None and schema is None:
            raise StorageError("MemoryDataSource needs a batch or a schema")
        self._batch = batch if batch is not None \
            else ColumnBatch.empty(schema, device=device)
        self.name = name
        self.indexes = IndexManager()
        # SERIAL column -> next auto-increment value (session DML fills)
        self.serials: dict = {}

    # ---- DataSource ----------------------------------------------------
    def scan(self) -> ColumnBatch:
        return self._batch

    def schema(self) -> Schema:
        return self._batch.schema

    @property
    def num_rows(self) -> int:
        return self._batch.num_rows

    # ---- mutation (DML backing store) ----------------------------------
    def replace(self, batch: ColumnBatch) -> None:
        self._batch = batch
        self.rebuild_indexes()

    def append(self, batch: ColumnBatch) -> None:
        """Append rows, keeping indexes updated (memory.rs:277-302)."""
        start_row = self._batch.num_rows
        self._batch = ColumnBatch.concat([self._batch, batch])
        for idx_name in self.indexes.table_indexes(self.name):
            meta = self.indexes.metadata(idx_name)
            self._insert_into_index(idx_name, meta.columns, batch, start_row)

    # ---- indexing ------------------------------------------------------
    def create_index(self, name: str, columns: Sequence[str],
                     index_type: str = "btree", unique: bool = False) -> None:
        self.indexes.create_index(
            name, self.name, list(columns), index_type, unique
        )
        self._insert_into_index(name, list(columns), self._batch, 0)

    def drop_index(self, name: str) -> None:
        self.indexes.drop_index(name)

    def rebuild_indexes(self) -> None:
        for idx_name in self.indexes.table_indexes(self.name):
            meta = self.indexes.metadata(idx_name)
            self.indexes.get(idx_name).clear()
            self._insert_into_index(idx_name, meta.columns, self._batch, 0)

    def _insert_into_index(self, idx_name: str, columns: List[str],
                           batch: ColumnBatch, start_row: int) -> None:
        """Rows with global row ids (memory.rs:124-141), all at once."""
        cols = [batch.column(c) for c in columns]
        self.indexes.get(idx_name).bulk_load_columns(
            cols, batch.num_rows, start_row)

    def index_lookup(self, idx_name: str, key) -> np.ndarray:
        return np.asarray(self.indexes.get(idx_name).lookup(key), dtype=np.int64)

    def index_range_scan(self, idx_name: str, low, high,
                         include_low=True, include_high=True) -> np.ndarray:
        return np.asarray(
            self.indexes.get(idx_name).range_scan(low, high, include_low, include_high),
            dtype=np.int64,
        )

    def fetch_rows(self, row_ids: np.ndarray) -> ColumnBatch:
        return self._batch.take_host(np.asarray(row_ids, dtype=np.int64))
