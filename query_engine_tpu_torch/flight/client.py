"""Arrow Flight client.

Parity surface: reference crates/query-flight/src/client.rs:19-295 —
connect, execute_sql via do_get + record-batch stream decode (:48-71),
list_tables/list_flights, get_table_schema/get_query_info, clear_tables,
handshake, upload_table via do_put (:185-233), exchange (:239-294).
"""

from __future__ import annotations

import json
from typing import List, Optional

import pyarrow as pa
import pyarrow.flight as flight

from query_engine_tpu_torch.core.config import FlightEndpoint
from query_engine_tpu_torch.core.errors import FlightError
from query_engine_tpu_torch.columnar.batch import ColumnBatch


class FlightClient:
    def __init__(self, endpoint):
        if isinstance(endpoint, FlightEndpoint):
            url = endpoint.url
        else:
            url = str(endpoint)
        if not url.startswith("grpc"):
            url = f"grpc://{url}"
        try:
            self._client = flight.connect(url)
        except Exception as e:  # noqa: BLE001
            raise FlightError(f"cannot connect to {url}: {e}")
        self.url = url

    @staticmethod
    def connect(url: str) -> "FlightClient":
        return FlightClient(url)

    # ---- queries ---------------------------------------------------------
    def execute_sql(self, sql: str) -> ColumnBatch:
        try:
            reader = self._client.do_get(flight.Ticket(sql.encode()))
            table = reader.read_all()
        except flight.FlightError as e:
            raise FlightError(str(e))
        return ColumnBatch.from_arrow(table)

    def get_query_info(self, sql: str):
        desc = flight.FlightDescriptor.for_command(sql.encode())
        return self._client.get_flight_info(desc)

    def get_table_schema(self, name: str):
        desc = flight.FlightDescriptor.for_path(name)
        return self._client.get_schema(desc).schema

    def poll_flight_info(self, name: Optional[str] = None,
                         sql: Optional[str] = None) -> dict:
        """PollFlightInfo (reference server.rs:283-321) via the
        "poll_flight_info" action (pyarrow bindings lack the raw RPC).
        Returns {progress, ticket, total_records, schema} with the schema
        decoded back to a pyarrow.Schema."""
        import base64

        body = json.dumps(
            {"path": [name]} if name is not None else {"cmd": sql}
        ).encode("utf-8")
        results = self._client.do_action(
            flight.Action("poll_flight_info", body))
        for r in results:
            info = json.loads(r.body.to_pybytes())
            info["schema"] = pa.ipc.read_schema(
                pa.py_buffer(base64.b64decode(info.pop("schema_ipc_b64"))))
            return info
        raise FlightError("poll_flight_info returned no result")

    # ---- tables ----------------------------------------------------------
    def list_tables(self) -> List[str]:
        results = self._client.do_action(flight.Action("list_tables", b""))
        for r in results:
            return json.loads(r.body.to_pybytes())
        return []

    def list_flights(self):
        return list(self._client.list_flights())

    def clear_tables(self) -> None:
        list(self._client.do_action(flight.Action("clear_tables", b"")))

    def upload_table(self, name: str, batch: ColumnBatch) -> None:
        """do_put upload (client.rs:185-233)."""
        table = pa.Table.from_batches([batch.to_arrow()])
        desc = flight.FlightDescriptor.for_path(name)
        writer, _ = self._client.do_put(desc, table.schema)
        writer.write_table(table)
        writer.close()

    def exchange(self, batch: ColumnBatch, store_as: Optional[str] = None) -> ColumnBatch:
        """Bidirectional round trip (client.rs:239-294)."""
        table = pa.Table.from_batches([batch.to_arrow()])
        desc = (
            flight.FlightDescriptor.for_path(store_as)
            if store_as else flight.FlightDescriptor.for_command(b"echo")
        )
        writer, reader = self._client.do_exchange(desc)
        writer.begin(table.schema)
        writer.write_table(table)
        writer.done_writing()
        out = reader.read_all()
        writer.close()
        return ColumnBatch.from_arrow(out)

    def handshake(self) -> bool:
        try:
            list(self._client.do_action(flight.Action("health_check", b"")))
            return True
        except Exception:  # noqa: BLE001
            return False

    def close(self) -> None:
        self._client.close()
