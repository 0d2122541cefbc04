"""Flight-backed data source + stream source.

Parity surface:
* FlightDataSource — reference crates/query-flight/src/data_source.rs:15-100:
  a DataSource that fetches from a remote Flight server and caches batches.
* FlightStreamSource — reference crates/query-flight/src/stream_source.rs:
  15-113: buffers a remote result and replays it batch-by-batch.
"""

from __future__ import annotations

from typing import List, Optional

from query_engine_tpu_torch.core.schema import Schema
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.flight.client import FlightClient
from query_engine_tpu_torch.streaming.source import StreamSource


class FlightDataSource:
    def __init__(self, endpoint: str, query: str):
        self.endpoint = endpoint
        self.query = query
        self._cached: Optional[ColumnBatch] = None

    def _fetch(self) -> ColumnBatch:
        if self._cached is None:
            client = FlightClient(self.endpoint)
            try:
                self._cached = client.execute_sql(self.query)
            finally:
                client.close()
        return self._cached

    def scan(self) -> ColumnBatch:
        return self._fetch()

    def schema(self) -> Schema:
        return self._fetch().schema

    def invalidate(self) -> None:
        self._cached = None


class FlightStreamSource(StreamSource):
    def __init__(self, endpoint: str, query: str, batch_rows: int = 1024):
        self.endpoint = endpoint
        self.query = query
        self.batch_rows = batch_rows
        self._chunks: Optional[List[ColumnBatch]] = None
        self._pos = 0

    def _load(self):
        if self._chunks is None:
            client = FlightClient(self.endpoint)
            try:
                result = client.execute_sql(self.query)
            finally:
                client.close()
            self._chunks = []
            for off in range(0, max(result.num_rows, 1), self.batch_rows):
                chunk = result.slice(off, self.batch_rows)
                if chunk.num_rows:
                    self._chunks.append(chunk)

    def next_batch(self, timeout=None) -> Optional[ColumnBatch]:
        self._load()
        if self._pos >= len(self._chunks):
            return None
        b = self._chunks[self._pos]
        self._pos += 1
        return b

    def is_exhausted(self) -> bool:
        self._load()
        return self._pos >= len(self._chunks)

    def name(self) -> str:
        return f"flight:{self.endpoint}"
