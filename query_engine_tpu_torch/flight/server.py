"""Arrow Flight server: the network data plane.

Parity surface: reference crates/query-flight/src/server.rs:71-592 — all
Flight RPCs: handshake (no-op), list_flights, get_flight_info,
poll_flight_info (server.rs:283-321; exposed as the "poll_flight_info"
action because pyarrow's Python bindings do not surface the PollFlightInfo
RPC — same request/response contract: descriptor in, {info, progress: 1.0}
out), get_schema, do_get (execute a query), do_put (upload -> register
table), do_action (clear_tables / list_tables), do_exchange (optionally
store, echo back).

Claimed-semantics upgrade: the reference's do_get "query" path is only a
table scan (extract_table_name pulls the word after FROM, server.rs:147-189);
here the ticket SQL runs through the full engine Session.

The port's counterpart of `query_engine_tpu.flight.server`: `FlightServer()`
builds `Session()`, which lies on the card; every Session call runs under
the Session's `lock`, since gRPC serves requests from a thread pool (a
pgwire server over the same Session takes the same lock), and a result's
planes come to the host once (`ColumnBatch.to_arrow`). Needs pyarrow.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

import pyarrow as pa
import pyarrow.flight as flight

from query_engine_tpu_torch.core.config import FlightConfig
from query_engine_tpu_torch.core.errors import QueryError
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.session import Session


class FlightServiceImpl(flight.FlightServerBase):
    """In-memory table store + real SQL execution (server.rs:33-68 TableStore)."""

    def __init__(self, config: Optional[FlightConfig] = None,
                 session: Optional[Session] = None, port: int = 0):
        self.config = config or FlightConfig()
        location = f"grpc://{self.config.host}:{port or self.config.port}"
        super().__init__(location)
        self.session = session if session is not None else Session()

    def shutdown(self):
        """Stop serving, then let go of the Session: pyarrow's C++ server
        keeps this object alive after it stops, and the Session's tables
        on the card with it."""
        super().shutdown()
        self.session = None

    # ---- helpers ---------------------------------------------------------
    def _execute_sql(self, sql: str) -> ColumnBatch:
        with self.session.lock:
            return self.session.sql(sql)

    # ---- RPCs ------------------------------------------------------------
    def do_get(self, context, ticket):
        sql = ticket.ticket.decode("utf-8")
        try:
            with self.session.lock:  # to_arrow reads the result's planes
                batch = self.session.sql(sql).to_arrow()
        except QueryError as e:
            raise flight.FlightServerError(str(e))
        table = pa.Table.from_batches([batch])
        return flight.RecordBatchStream(table)

    def do_put(self, context, descriptor, reader, writer):
        """Upload -> register table (server.rs:385-452)."""
        name = descriptor.path[0].decode("utf-8") if descriptor.path else (
            descriptor.command.decode("utf-8")
        )
        table = reader.read_all()
        batch = ColumnBatch.from_arrow(table)
        with self.session.lock:
            self.session.register_table(name, batch)

    def do_exchange(self, context, descriptor, reader, writer):
        """Bidirectional: optionally store, echo back (server.rs:513-591)."""
        store = bool(descriptor.path)
        batches = []
        for chunk in reader:
            if chunk.data is not None:
                batches.append(chunk.data)
        if not batches:
            return
        table = pa.Table.from_batches(batches)
        if store:
            name = descriptor.path[0].decode("utf-8")
            with self.session.lock:
                self.session.register_table(name, ColumnBatch.from_arrow(table))
        writer.begin(table.schema)
        for b in table.to_batches():
            writer.write_batch(b)

    def list_flights(self, context, criteria):
        with self.session.lock:
            for name in self.session.tables():
                schema = self.session.table_schema(name).to_arrow()
                desc = flight.FlightDescriptor.for_path(name)
                src = self.session.sources[name]
                rows = getattr(src, "num_rows", -1)
                yield flight.FlightInfo(
                    schema, desc,
                    [flight.FlightEndpoint(name.encode(), [])],
                    rows, -1,
                )

    def get_flight_info(self, context, descriptor):
        if descriptor.path:
            name = descriptor.path[0].decode("utf-8")
            with self.session.lock:
                schema = self.session.table_schema(name).to_arrow()
                rows = getattr(self.session.sources[name.lower()],
                               "num_rows", -1)
            return flight.FlightInfo(
                schema, descriptor,
                [flight.FlightEndpoint(name.encode(), [])], rows, -1,
            )
        sql = descriptor.command.decode("utf-8")
        result = self._execute_sql(sql)
        return flight.FlightInfo(
            result.schema.to_arrow(), descriptor,
            [flight.FlightEndpoint(sql.encode(), [])], result.num_rows, -1,
        )

    def get_schema(self, context, descriptor):
        info = self.get_flight_info(context, descriptor)
        return flight.SchemaResult(info.schema)

    def do_action(self, context, action):
        """clear_tables / list_tables (server.rs:455-487)."""
        if action.type == "list_tables":
            with self.session.lock:
                names = self.session.tables()
            yield flight.Result(json.dumps(names).encode())
        elif action.type == "clear_tables":
            with self.session.lock:
                for name in list(self.session.tables()):
                    self.session.deregister_table(name)
            yield flight.Result(b"ok")
        elif action.type == "health_check":
            yield flight.Result(b"ok")
        elif action.type == "poll_flight_info":
            yield flight.Result(self._poll_flight_info(action.body.to_pybytes()))
        else:
            raise flight.FlightServerError(f"unknown action {action.type}")

    def _poll_flight_info(self, body: bytes) -> bytes:
        """PollFlightInfo semantics (reference server.rs:283-321): resolve
        the descriptor to a table/query, return its FlightInfo with
        progress = 1.0 — this engine materializes results synchronously, so
        a poll is always complete (ditto the reference). Body is JSON
        {"path": [name]} or {"cmd": sql}; response is JSON with the schema
        (base64 Arrow IPC), ticket, row count, and progress."""
        import base64

        try:
            req = json.loads(body.decode("utf-8")) if body else {}
        except ValueError:
            req = {"cmd": body.decode("utf-8", "replace")}
        path = req.get("path") or []
        cmd = req.get("cmd")
        if path:
            name = path[0]
            with self.session.lock:
                if name not in self.session.tables():
                    raise flight.FlightServerError(f"Table not found: {name}")
                schema = self.session.table_schema(name).to_arrow()
                rows = getattr(self.session.sources[name.lower()],
                               "num_rows", -1)
            ticket = name
        elif cmd:
            result = self._execute_sql(cmd)
            schema, rows, ticket = result.schema.to_arrow(), result.num_rows, cmd
        else:
            raise flight.FlightServerError("No table specified")
        return json.dumps({
            "progress": 1.0,
            "expiration_time": None,
            "ticket": ticket,
            "total_records": rows,
            "schema_ipc_b64": base64.b64encode(
                schema.serialize().to_pybytes()).decode("ascii"),
        }).encode("utf-8")

    def list_actions(self, context):
        return [
            ("list_tables", "List registered tables"),
            ("clear_tables", "Drop all registered tables"),
            ("health_check", "Liveness probe"),
            ("poll_flight_info", "PollFlightInfo: descriptor JSON -> "
             "{info, progress} (always complete)"),
        ]


class FlightServer:
    """Lifecycle wrapper (server.rs FlightServer::serve)."""

    def __init__(self, config: Optional[FlightConfig] = None,
                 session: Optional[Session] = None):
        self.config = config or FlightConfig()
        self.service = FlightServiceImpl(self.config, session)

    @property
    def port(self) -> int:
        return self.service.port

    @property
    def session(self) -> Session:
        return self.service.session

    def serve_blocking(self):
        self.service.serve()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.service.serve, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.service.shutdown()
