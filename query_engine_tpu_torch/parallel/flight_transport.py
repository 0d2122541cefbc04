"""Flight-based distributed transport (DCN / cross-cluster fallback).

Parity surface: reference crates/query-distributed/src/flight_transport.rs:
10-108 — the reference's only *wired* distributed path: hold worker
FlightEndpoints, execute_on_worker ships SQL text over Arrow Flight,
execute_on_all fans out; DistributedTransport trait.

Each worker is a Flight server over its own Session (flight/server.py);
results come back through the port's FlightClient as CPU batches.
execute_on_all fans out concurrently (the reference loops sequentially).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Protocol

from query_engine_tpu_torch.core.config import FlightEndpoint
from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.columnar.batch import ColumnBatch


class DistributedTransport(Protocol):
    def execute_on_worker(self, worker_id: str, sql: str) -> ColumnBatch: ...

    def execute_on_all(self, sql: str) -> List[ColumnBatch]: ...


class FlightTransport:
    def __init__(self):
        self._endpoints: Dict[str, FlightEndpoint] = {}

    def add_worker(self, worker_id: str, endpoint) -> None:
        if isinstance(endpoint, str):
            endpoint = FlightEndpoint(url=endpoint)
        self._endpoints[worker_id] = endpoint

    def remove_worker(self, worker_id: str) -> None:
        self._endpoints.pop(worker_id, None)

    def workers(self) -> List[str]:
        return list(self._endpoints)

    def execute_on_worker(self, worker_id: str, sql: str) -> ColumnBatch:
        ep = self._endpoints.get(worker_id)
        if ep is None:
            raise DistributedError(f"unknown worker '{worker_id}'")
        from query_engine_tpu_torch.flight.client import FlightClient

        client = FlightClient(ep)
        try:
            return client.execute_sql(sql)
        finally:
            client.close()

    def execute_on_all(self, sql: str) -> List[ColumnBatch]:
        if not self._endpoints:
            return []
        with ThreadPoolExecutor(max_workers=len(self._endpoints)) as pool:
            futures = [
                pool.submit(self.execute_on_worker, wid, sql)
                for wid in self._endpoints
            ]
            return [f.result() for f in futures]

    def upload_to_worker(self, worker_id: str, table: str,
                         batch: ColumnBatch) -> None:
        ep = self._endpoints.get(worker_id)
        if ep is None:
            raise DistributedError(f"unknown worker '{worker_id}'")
        from query_engine_tpu_torch.flight.client import FlightClient

        client = FlightClient(ep)
        try:
            client.upload_table(table, batch)
        finally:
            client.close()
