"""CSV data source.

Parity surface: reference crates/query-storage/src/csv.rs:8-43 (Arrow CSV
reader with header + caller-supplied schema) and the CLI's 1000-row type
sniffing (commands.rs:399-500) — pyarrow's reader gives us both.

The reference fixtures use the literal string NULL for nulls
(data/employees.csv row 6), so NULL/empty are configured null markers.
"""

from __future__ import annotations

from typing import Optional

import pyarrow as pa
import pyarrow.csv as pacsv

from query_engine_tpu_torch.core.errors import StorageError
from query_engine_tpu_torch.core.schema import Schema
from query_engine_tpu_torch.columnar.batch import ColumnBatch


class CsvDataSource:
    def __init__(self, path: str, schema: Optional[Schema] = None):
        self.path = path
        self._schema = schema
        self._batch: Optional[ColumnBatch] = None

    def _load(self) -> ColumnBatch:
        if self._batch is None:
            convert = pacsv.ConvertOptions(
                null_values=["NULL", "null", ""], strings_can_be_null=True
            )
            if self._schema is not None:
                convert = pacsv.ConvertOptions(
                    null_values=["NULL", "null", ""],
                    strings_can_be_null=True,
                    column_types={
                        f.name: f.data_type.to_arrow() for f in self._schema
                    },
                )
            try:
                table = pacsv.read_csv(self.path, convert_options=convert)
            except (pa.ArrowInvalid, FileNotFoundError, OSError) as e:
                raise StorageError(f"cannot read CSV '{self.path}': {e}")
            self._batch = ColumnBatch.from_arrow(table)
            if self._schema is None:
                self._schema = self._batch.schema
        return self._batch

    def scan(self) -> ColumnBatch:
        return self._load()

    def schema(self) -> Schema:
        if self._schema is None:
            self._load()
        return self._schema
