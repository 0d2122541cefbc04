"""PostgreSQL wire-protocol server over the engine Session.

Parity surface:
* PgServer — reference crates/query-pgwire/src/server.rs:34-359: TCP accept
  loop, per-connection backend over a shared table map, load_csv/
  register_table helpers, +-auth variants, and TLS termination via the
  SSLRequest/STARTTLS upgrade (pgwire/tls.py; exercised with generated
  certificates in tests/test_pgwire.py).
* QueryBackend dispatch — reference backend.rs:28-2603: statement splitting,
  SHOW TABLES / DESCRIBE (:781-805,963-1039), BEGIN/COMMIT/ROLLBACK no-ops
  (:807-832), pg_catalog / information_schema shims (:834-850), COPY
  (:853-863,1984+), DECLARE/FETCH/CLOSE cursors (:866-898,2302-2451), and the
  default path Parse->Plan->Optimize->lower->execute (:159-218,546-604) —
  which here is simply Session.sql, the same pipeline every entry point uses.
* Extended protocol — reference extended.rs:37-593: prepared statements,
  $n parameters, describe statement/portal via the logical plan, portals
  with max_rows suspension.

The port's counterpart of `query_engine_tpu.pgwire.server`, over the port's
Session: `PgServer()` builds `Session()`, which lies on the card. The
Session is shared by every connection (a transaction is server-scoped, as
in the reference), and every Session call and every read of a result's
planes runs under the Session's own `lock`, the JAX server's three
unlocked calls (DECLARE's query, COPY TO's and COPY FROM's INSERT) and the
extended protocol's Execute included. Every front end over one Session
takes that one lock, so two servers over it never run side by side; the
pipeline captures in torch's thread-local mode, so CUDA work of another
thread (another Session's) does not break a capture.
"""

from __future__ import annotations

import asyncio
import re
import struct
from typing import Dict, List, Optional

from query_engine_tpu_torch.core.errors import QueryError
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.pgwire import protocol as P
from query_engine_tpu_torch.pgwire.auth import AuthConfig, AuthMethod
from query_engine_tpu_torch.pgwire.catalog import handle_catalog_query, pg_type_name
from query_engine_tpu_torch.pgwire.cursor import CursorStore, Portal, PreparedStatement
from query_engine_tpu_torch.pgwire.result import (
    batch_to_data_rows, schema_to_field_info,
)
from query_engine_tpu_torch.sql import ast
from query_engine_tpu_torch.sql.parser import parse_sql


def split_statements(text: str) -> List[str]:
    """Split on ';' respecting single/double quotes."""
    out, buf, quote = [], [], None
    for ch in text:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
            buf.append(ch)
        elif ch == ";":
            stmt = "".join(buf).strip()
            if stmt:
                out.append(stmt)
            buf = []
        else:
            buf.append(ch)
    stmt = "".join(buf).strip()
    if stmt:
        out.append(stmt)
    return out


class PgConnection:
    def __init__(self, reader, writer, session: Session, auth: AuthConfig,
                 ssl_context=None):
        self.reader = reader
        self.writer = writer
        self.session = session
        self.auth = auth
        self.ssl_context = ssl_context
        self.cursors = CursorStore()
        self.statements: Dict[str, PreparedStatement] = {}
        self.portals: Dict[str, Portal] = {}
        self.user = ""
        self._in_error = False  # extended-protocol error: skip until Sync

    # ---- IO helpers ----------------------------------------------------
    def _txn_status(self) -> bytes:
        """ReadyForQuery status byte: I idle, T in transaction, E failed."""
        with self.session.lock:
            if self.session.transaction_failed():
                return b"E"
            return b"T" if self.session.in_transaction() else b"I"

    def send(self, data: bytes) -> None:
        self.writer.write(data)

    async def flush(self) -> None:
        await self.writer.drain()

    async def read_message(self):
        tag = await self.reader.readexactly(1)
        (length,) = struct.unpack("!I", await self.reader.readexactly(4))
        payload = await self.reader.readexactly(length - 4)
        return tag, payload

    # ---- lifecycle -----------------------------------------------------
    async def run(self) -> None:
        if not await self._handshake():
            return
        try:
            while True:
                try:
                    tag, payload = await self.read_message()
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                if tag == b"X":
                    return
                await self._dispatch(tag, payload)
        finally:
            self.writer.close()

    async def _handshake(self) -> bool:
        while True:
            (length,) = struct.unpack("!I", await self.reader.readexactly(4))
            payload = await self.reader.readexactly(length - 4)
            msg = P.parse_startup(payload)
            if msg.protocol == P.SSL_REQUEST:
                if self.ssl_context is None:
                    self.send(b"N")  # no TLS on this listener
                    await self.flush()
                    continue
                # PostgreSQL STARTTLS upgrade (tls.rs parity)
                self.send(b"S")
                await self.flush()
                await self.writer.start_tls(self.ssl_context)
                continue
            if msg.protocol == P.GSSENC_REQUEST:
                self.send(b"N")
                await self.flush()
                continue
            if msg.protocol == P.CANCEL_REQUEST:
                return False
            break
        self.user = msg.params.get("user", "")

        if self.auth.method is AuthMethod.TRUST:
            self.send(P.auth_ok())
        elif self.auth.method is AuthMethod.CLEARTEXT:
            self.send(P.auth_cleartext())
            await self.flush()
            tag, payload = await self.read_message()
            if tag != b"p":
                return False
            password, _ = P.read_cstr(payload, 0)
            if not self.auth.verify_cleartext(self.user, password):
                self.send(P.error_response(
                    f'password authentication failed for user "{self.user}"',
                    "28P01",
                    "FATAL",
                ))
                await self.flush()
                return False
            self.send(P.auth_ok())
        elif self.auth.method is AuthMethod.SCRAM_SHA_256:
            if not await self._scram_handshake():
                return False
            self.send(P.auth_ok())
        else:  # MD5
            salt = P.random_salt()
            self.send(P.auth_md5(salt))
            await self.flush()
            tag, payload = await self.read_message()
            if tag != b"p":
                return False
            response, _ = P.read_cstr(payload, 0)
            if not self.auth.verify_md5(self.user, response, salt):
                self.send(P.error_response(
                    f'password authentication failed for user "{self.user}"',
                    "28P01",
                    "FATAL",
                ))
                await self.flush()
                return False
            self.send(P.auth_ok())

        for k, v in [
            ("server_version", "14.0"),
            ("server_encoding", "UTF8"),
            ("client_encoding", "UTF8"),
            ("DateStyle", "ISO, MDY"),
            ("integer_datetimes", "on"),
            ("standard_conforming_strings", "on"),
        ]:
            self.send(P.parameter_status(k, v))
        self.send(P.backend_key_data(1, 0))
        self.send(P.ready_for_query())
        await self.flush()
        return True

    async def _scram_handshake(self) -> bool:
        """SCRAM-SHA-256 over the wire (RFC 7677; auth.rs:186-209 parity)."""
        password = self.auth.users.get(self.user)
        if password is None:
            self.send(P.error_response(
                f'password authentication failed for user "{self.user}"',
                "28P01", "FATAL",
            ))
            await self.flush()
            return False
        self.send(P.auth_sasl())
        await self.flush()
        tag, payload = await self.read_message()
        if tag != b"p":
            return False
        mechanism, pos = P.read_cstr(payload, 0)
        if mechanism != "SCRAM-SHA-256":
            self.send(P.error_response("unsupported SASL mechanism", "28000"))
            await self.flush()
            return False
        (ln,) = __import__("struct").unpack_from("!i", payload, pos)
        client_first = payload[pos + 4: pos + 4 + ln].decode()
        scram = P.ScramServer(password)
        self.send(P.auth_sasl_continue(
            scram.handle_client_first(client_first).encode()
        ))
        await self.flush()
        tag, payload = await self.read_message()
        if tag != b"p":
            return False
        server_final = scram.verify_client_final(payload.decode())
        if server_final is None:
            self.send(P.error_response(
                f'password authentication failed for user "{self.user}"',
                "28P01", "FATAL",
            ))
            await self.flush()
            return False
        self.send(P.auth_sasl_final(server_final.encode()))
        return True

    # ---- dispatch ------------------------------------------------------
    async def _dispatch(self, tag: bytes, payload: bytes) -> None:
        if tag == b"Q":
            sql, _ = P.read_cstr(payload, 0)
            await self._simple_query(sql)
            return
        if self._in_error and tag != b"S":
            return
        if tag == b"P":
            self._handle_parse(payload)
        elif tag == b"B":
            self._handle_bind(payload)
        elif tag == b"D":
            with self.session.lock:
                self._handle_describe(payload)
        elif tag == b"E":
            with self.session.lock:
                self._handle_execute(payload)
        elif tag == b"C":
            msg = P.parse_close(payload)
            if msg.kind == "S":
                self.statements.pop(msg.name, None)
            else:
                self.portals.pop(msg.name, None)
            self.send(P.close_complete())
        elif tag == b"S":
            self._in_error = False
            self.send(P.ready_for_query(self._txn_status()))
        elif tag == b"H":
            pass  # Flush
        elif tag == b"p":
            pass  # stray password message
        else:
            self.send(P.error_response(f"unsupported message {tag!r}", "0A000"))
        await self.flush()

    # ---- simple query --------------------------------------------------
    async def _simple_query(self, sql: str) -> None:
        statements = split_statements(sql)
        if not statements:
            self.send(P.empty_query_response())
            self.send(P.ready_for_query(self._txn_status()))
            await self.flush()
            return
        for stmt in statements:
            try:
                await self._execute_one(stmt)
            except QueryError as e:
                self.send(P.error_response(e.message, "42601"))
                break
            except Exception as e:  # noqa: BLE001 protocol boundary
                self.send(P.error_response(str(e), "XX000"))
                break
        self.send(P.ready_for_query(self._txn_status()))
        await self.flush()

    async def _execute_one(self, sql: str) -> None:
        word = (sql.split(None, 1) + [""])[0].upper()
        if word == "COPY":
            await self._handle_copy(sql)
            return
        with self.session.lock:
            self._execute_locked(sql, word)

    def _execute_locked(self, sql: str, word: str) -> None:
        """One statement other than COPY, under the Session's lock."""
        # session-variable no-ops (backend.rs:807-832). BEGIN/COMMIT/
        # ROLLBACK/SAVEPOINT fall through to the engine, which gives them
        # real snapshot semantics (the reference no-ops them); the Session
        # is shared across connections, so the transaction is server-scoped
        # like the shared table map.
        if word in ("SET", "RESET", "DISCARD"):
            self.send(P.command_complete(word))
            return
        if word == "SHOW":
            self._handle_show(sql)
            return
        if word == "DESCRIBE":
            self._handle_describe_table(sql)
            return
        if word == "DECLARE":
            self._handle_declare(sql)
            return
        if word == "FETCH":
            self._handle_fetch(sql)
            return
        if word == "CLOSE":
            name = sql.split()[1].strip().rstrip(";")
            self.cursors.close(name)
            self.send(P.command_complete("CLOSE CURSOR"))
            return
        catalog = handle_catalog_query(self.session, sql)
        if catalog is not None:
            self._send_result(catalog, f"SELECT {catalog.num_rows}")
            return

        if word == "EXPLAIN":
            result = self.session.sql(sql)
            self._send_result(result, f"SELECT {result.num_rows}")
            return

        stmt = parse_sql(sql)
        # the Session is shared across connections (server.rs shared table
        # map); engine execution + DML mutate shared state: the caller holds
        # the Session's lock
        result = self.session.execute_statement(stmt, sql_text=sql)
        self._send_stmt_result(stmt, result)

    def _send_stmt_result(self, stmt, result: ColumnBatch) -> None:
        if isinstance(stmt, (ast.Select, ast.WithSelect)):
            self._send_result(result, f"SELECT {result.num_rows}")
        elif isinstance(stmt, ast.Insert):
            if stmt.returning is not None:
                self._send_result(result, f"INSERT 0 {result.num_rows}")
            else:
                self.send(P.command_complete(self._status_tag(result, "INSERT 0 0")))
        elif isinstance(stmt, (ast.Update, ast.Delete)):
            kind = "UPDATE" if isinstance(stmt, ast.Update) else "DELETE"
            if stmt.returning is not None:
                self._send_result(result, f"{kind} {result.num_rows}")
            else:
                self.send(P.command_complete(self._status_tag(result, f"{kind} 0")))
        else:
            self.send(P.command_complete(self._status_tag(result, "OK")))

    @staticmethod
    def _status_tag(result: ColumnBatch, default: str) -> str:
        try:
            if result.schema.names() == ["status"] and result.num_rows == 1:
                return result.columns[0].to_pylist(1)[0]
        except Exception:  # noqa: BLE001
            pass
        return default

    def _send_result(self, batch: ColumnBatch, tag: str) -> None:
        self.send(P.row_description(schema_to_field_info(batch.schema)))
        for row in batch_to_data_rows(batch):
            self.send(P.data_row(row))
        self.send(P.command_complete(tag))

    # ---- SHOW / DESCRIBE (backend.rs:781-805,963-1039) ------------------
    def _handle_show(self, sql: str) -> None:
        arg = sql.split(None, 1)[1].strip().rstrip(";").lower()
        if arg == "tables":
            tables = self.session.tables()
            views = self.session.views()
            batch = ColumnBatch.from_pydict({
                "table_name": tables + views,
                "table_type": (["BASE TABLE"] * len(tables)
                               + ["VIEW"] * len(views)),
            })
            self._send_result(batch, f"SELECT {batch.num_rows}")
            return
        values = {
            "server_version": "14.0",
            "transaction isolation level": "read committed",
            "standard_conforming_strings": "on",
            "client_encoding": "UTF8",
        }
        batch = ColumnBatch.from_pydict({arg: [values.get(arg, "unset")]})
        self._send_result(batch, "SHOW")

    def _handle_describe_table(self, sql: str) -> None:
        name = sql.split()[1].strip().rstrip(";")
        schema = self.session.table_schema(name)
        batch = ColumnBatch.from_pydict(
            {
                "column_name": [f.name.rsplit(".", 1)[-1] for f in schema],
                "data_type": [pg_type_name(f.data_type) for f in schema],
                "nullable": ["YES" if f.nullable else "NO" for f in schema],
            }
        )
        self._send_result(batch, f"SELECT {batch.num_rows}")

    # ---- cursors (backend.rs:866-898,2302-2451) --------------------------
    def _handle_declare(self, sql: str) -> None:
        m = re.match(r"DECLARE\s+(\w+)\s+CURSOR\s+FOR\s+(.*)", sql,
                     re.IGNORECASE | re.DOTALL)
        if not m:
            raise QueryError("syntax error in DECLARE CURSOR")
        name, query = m.group(1), m.group(2)
        result = self.session.sql(query)
        self.cursors.declare(name, result)
        self.send(P.command_complete("DECLARE CURSOR"))

    def _handle_fetch(self, sql: str) -> None:
        m = re.match(
            r"FETCH\s+(?:(ALL|\d+)\s+)?(?:FROM\s+|IN\s+)?(\w+)", sql,
            re.IGNORECASE,
        )
        if not m:
            raise QueryError("syntax error in FETCH")
        count = m.group(1)
        n = None if (count is None or count.upper() == "ALL") else int(count)
        batch = self.cursors.fetch(m.group(2), n)
        self._send_result(batch, f"FETCH {batch.num_rows}")

    # ---- COPY (backend.rs:853-863,1984+) ---------------------------------
    async def _handle_copy(self, sql: str) -> None:
        m = re.match(
            r"COPY\s+(\w+)(?:\s*\(([^)]*)\))?\s+(FROM\s+STDIN|TO\s+STDOUT)",
            sql, re.IGNORECASE,
        )
        if not m:
            raise QueryError("unsupported COPY syntax")
        table = m.group(1)
        direction = m.group(3).upper().replace(" ", "")
        with self.session.lock:
            schema = self.session.table_schema(table)
        names = [f.name.rsplit(".", 1)[-1] for f in schema]
        cols = [c.strip() for c in m.group(2).split(",")] if m.group(2) else names

        if direction == "TOSTDOUT":
            with self.session.lock:
                batch = self.session.sql(f"SELECT * FROM {table}")
                rows = batch.to_pylist()
            self.send(P.copy_out_response(len(cols)))
            for row in rows:
                line = "\t".join(
                    r"\N" if v is None else str(v) for v in row
                ) + "\n"
                self.send(P.copy_data(line.encode()))
            self.send(P.copy_done())
            self.send(P.command_complete(f"COPY {batch.num_rows}"))
            return

        # COPY FROM STDIN: text format, tab-separated, \N for null
        self.send(P.copy_in_response(len(cols)))
        await self.flush()
        buf = b""
        while True:
            tag, payload = await self.read_message()
            if tag == b"d":
                buf += payload
            elif tag == b"c":
                break
            elif tag == b"f":
                self.send(P.error_response("COPY failed by client", "57014"))
                return
        rows = 0
        values_sql = []
        for line in buf.decode().splitlines():
            if not line or line == "\\.":
                continue
            parts = line.split("\t")
            lits = []
            for f_name, raw in zip(cols, parts):
                if raw == r"\N":
                    lits.append("NULL")
                else:
                    f = schema.field_with_name(
                        next(n for n in schema.names() if n.endswith(f_name) or n == f_name)
                    )
                    if f.data_type.is_numeric:
                        lits.append(raw)
                    else:
                        escaped = raw.replace("'", "''")
                        lits.append(f"'{escaped}'")
            values_sql.append("(" + ", ".join(lits) + ")")
            rows += 1
        if values_sql:
            col_list = ", ".join(cols)
            with self.session.lock:
                self.session.sql(f"INSERT INTO {table} ({col_list}) VALUES "
                                 f"{', '.join(values_sql)}")
        self.send(P.command_complete(f"COPY {rows}"))

    # ---- extended protocol (extended.rs:37-593) --------------------------
    def _handle_parse(self, payload: bytes) -> None:
        try:
            msg = P.parse_parse(payload)
            self.statements[msg.name] = PreparedStatement(
                msg.name, msg.query, msg.param_oids
            )
            self.send(P.parse_complete())
        except QueryError as e:
            self._in_error = True
            self.send(P.error_response(e.message))

    def _handle_bind(self, payload: bytes) -> None:
        try:
            msg = P.parse_bind(payload)
            stmt = self.statements.get(msg.statement)
            if stmt is None:
                raise QueryError(f"unknown prepared statement '{msg.statement}'")
            params = []
            for i, raw in enumerate(msg.params):
                if raw is None:
                    params.append(None)
                    continue
                fmt = (
                    msg.param_formats[i]
                    if i < len(msg.param_formats)
                    else (msg.param_formats[0] if msg.param_formats else 0)
                )
                if fmt != 0:
                    raise QueryError("binary parameters not supported")
                params.append(self._coerce_param(raw.decode(), stmt, i))
            self.portals[msg.portal] = Portal(msg.portal, stmt, params)
            self.send(P.bind_complete())
        except QueryError as e:
            self._in_error = True
            self.send(P.error_response(e.message))

    @staticmethod
    def _coerce_param(text: str, stmt: PreparedStatement, i: int):
        oid = stmt.param_oids[i] if i < len(stmt.param_oids) else 0
        if oid in (20, 21, 23):
            return int(text)
        if oid in (700, 701, 1700):
            return float(text)
        if oid == 16:
            return text in ("t", "true", "1")
        if oid == 0:
            # untyped: guess numerically, else string
            try:
                return int(text)
            except ValueError:
                try:
                    return float(text)
                except ValueError:
                    return text
        return text

    def _handle_describe(self, payload: bytes) -> None:
        try:
            msg = P.parse_describe(payload)
            if msg.kind == "S":
                stmt = self.statements.get(msg.name)
                if stmt is None:
                    raise QueryError(f"unknown prepared statement '{msg.name}'")
                self.send(P.parameter_description(stmt.param_oids))
                schema = self._statement_schema(stmt, None)
                if schema is None:
                    self.send(P.no_data())
                else:
                    self.send(P.row_description(schema_to_field_info(schema)))
            else:
                portal = self.portals.get(msg.name)
                if portal is None:
                    raise QueryError(f"unknown portal '{msg.name}'")
                schema = self._statement_schema(portal.statement, portal.params)
                if schema is None:
                    self.send(P.no_data())
                else:
                    self.send(P.row_description(schema_to_field_info(schema)))
        except QueryError as e:
            self._in_error = True
            self.send(P.error_response(e.message))

    def _statement_schema(self, stmt: PreparedStatement, params):
        """Describe via the logical plan (extended.rs:304-360)."""
        try:
            parsed = parse_sql(stmt.query)
        except QueryError:
            return None
        if not isinstance(parsed, (ast.Select, ast.WithSelect)):
            return None
        from query_engine_tpu_torch.engine.session import _bind_params

        if params is None:
            params = [None] * 32
        parsed = _bind_params(parsed, params)
        plan = self.session.planner.create_logical_plan(parsed)
        return plan.schema()

    def _handle_execute(self, payload: bytes) -> None:
        try:
            msg = P.parse_execute(payload)
            portal = self.portals.get(msg.portal)
            if portal is None:
                raise QueryError(f"unknown portal '{msg.portal}'")
            if portal.result is None:
                parsed = parse_sql(portal.statement.query)
                from query_engine_tpu_torch.engine.session import _bind_params

                parsed = _bind_params(parsed, portal.params)
                portal.result = self.session.execute_statement(
                    parsed, sql_text=""
                )
                portal.parsed = parsed
            batch, suspended = portal.fetch(msg.max_rows)
            for row in batch_to_data_rows(batch):
                self.send(P.data_row(row))
            if suspended:
                self.send(P.portal_suspended())
            else:
                parsed = getattr(portal, "parsed", None)
                if isinstance(parsed, (ast.Select, ast.WithSelect)) or parsed is None:
                    self.send(P.command_complete(f"SELECT {portal.position}"))
                else:
                    self.send(P.command_complete(
                        self._status_tag(portal.result, "OK")
                    ))
        except QueryError as e:
            self._in_error = True
            self.send(P.error_response(e.message))


class PgServer:
    """TCP accept loop (server.rs:175-226)."""

    def __init__(self, session: Optional[Session] = None,
                 host: str = "127.0.0.1", port: int = 5432,
                 auth: Optional[AuthConfig] = None, tls=None):
        self.session = session if session is not None else Session()
        self.host = host
        self.port = port
        self.auth = auth or AuthConfig.trust()
        self.tls = tls  # Optional[TlsConfig]
        self._ssl_context = tls.ssl_context() if tls is not None else None
        self._server: Optional[asyncio.AbstractServer] = None

    # ---- table helpers (server.rs:127-174) -------------------------------
    def load_csv(self, name: str, path: str) -> None:
        with self.session.lock:
            self.session.register_csv(name, path)

    def register_table(self, name: str, batch: ColumnBatch) -> None:
        with self.session.lock:
            self.session.register_table(name, batch)

    # ---- lifecycle -------------------------------------------------------
    async def _handle_conn(self, reader, writer):
        conn = PgConnection(reader, writer, self.session, self.auth,
                            ssl_context=self._ssl_context)
        try:
            await conn.run()
        except Exception:  # noqa: BLE001 connection isolation
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        return self._server

    async def serve_forever(self):
        server = await self.start()
        async with server:
            await server.serve_forever()

    def run(self):
        asyncio.run(self.serve_forever())
