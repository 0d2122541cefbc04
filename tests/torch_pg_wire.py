"""Helpers for driving pgwire servers over TCP in tests and in
`chip_smoke.py`: a thread that runs servers on one asyncio loop, and a
client that extends `tests/pg_client.PgTestClient` with the raw messages of
a query, the type OIDs of a RowDescription, named prepared statements with
Describe, and COPY TO STDOUT.

Works with the JAX package's `PgServer` and the port's alike (anything with
an `async start()` that returns an asyncio server). Imports neither.
"""

from __future__ import annotations

import asyncio
import datetime
import math
import struct
import threading
from typing import List, Optional, Tuple

from pg_client import PgTestClient

# the OIDs of pgwire/result.py
OID_INT = (20, 21, 23)
OID_FLOAT = (700, 701)
OID_DATE = 1082


class ServerThread:
    """Runs `servers` (each bound to port 0: a free port) on one asyncio
    loop in a daemon thread; `ports[i]` is server i's port once started."""

    def __init__(self, *servers):
        self.servers = servers
        self.ports: List[int] = []
        self._loop = None
        self._error: Optional[BaseException] = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @property
    def port(self) -> int:
        return self.ports[0]

    def _run(self):
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        listeners = []
        try:
            for srv in self.servers:
                listeners.append(loop.run_until_complete(srv.start()))
                self.ports.append(
                    listeners[-1].sockets[0].getsockname()[1])
        except Exception as e:  # noqa: BLE001 reported by start()
            self._error = e
        self._started.set()
        if self._error is None:
            loop.run_forever()
        for lst in listeners:
            lst.close()
        tasks = asyncio.all_tasks(loop)
        for t in tasks:
            t.cancel()
        loop.run_until_complete(
            asyncio.gather(*tasks, return_exceptions=True))
        loop.close()

    def start(self, timeout: float = 30.0) -> "ServerThread":
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("pgwire server did not start")
        if self._error is not None:
            raise RuntimeError(f"pgwire server failed: {self._error!r}")
        return self

    def stop(self, timeout: float = 30.0) -> None:
        if self._loop is not None and self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("pgwire server thread did not stop")


def row_description(body: bytes) -> List[Tuple[str, int]]:
    """(name, type OID) of each field of a RowDescription body."""
    (n,) = struct.unpack_from("!H", body)
    pos, out = 2, []
    for _ in range(n):
        end = body.index(b"\x00", pos)
        (oid,) = struct.unpack_from("!I", body, end + 1 + 6)
        out.append((body[pos:end].decode(), oid))
        pos = end + 1 + 18
    return out


def same_messages(got, want, rtol: float = 1e-9) -> None:
    """Asserts two servers' messages for the same requests equal byte for
    byte, except that a float8 field's text (OID 701) may differ where both
    values agree within rtol (sums taken in another order or in fixed
    point)."""
    assert [t for t, _ in got] == [t for t, _ in want]
    fields = []
    for (tag, a), (_, b) in zip(got, want):
        if tag == b"T":
            fields = row_description(b)
        if tag != b"D" or a == b:
            assert a == b, (tag, a, b)
            continue
        ra = PgTestClient._parse_data_row(a)
        rb = PgTestClient._parse_data_row(b)
        for x, y, (name, oid) in zip(ra, rb, fields):
            if x == y:
                continue
            assert oid == 701 and x is not None and y is not None, (
                name, x, y)
            assert math.isclose(float(x), float(y), rel_tol=rtol), (
                name, x, y)


def decode(text: Optional[str], oid: int):
    """A DataRow field's text as the Python value of its type OID."""
    if text is None:
        return None
    if oid in OID_INT:
        return int(text)
    if oid in OID_FLOAT:
        return float(text)
    if oid == OID_DATE:
        return datetime.date.fromisoformat(text)
    return text


class WireClient(PgTestClient):
    """PgTestClient plus the raw messages of each exchange."""

    def query_raw(self, sql: str) -> List[Tuple[bytes, bytes]]:
        """Every message the server sends for a simple query, up to and
        including ReadyForQuery, as (tag, body)."""
        self._send(self._msg(b"Q", sql.encode() + b"\x00"))
        return self._until_ready()

    def _until_ready(self) -> List[Tuple[bytes, bytes]]:
        msgs = []
        while True:
            tag, body = self._read_msg()
            msgs.append((tag, body))
            if tag == b"Z":
                self.last_txn_status = body[:1]
                return msgs

    def typed_query(self, sql: str):
        """(fields, rows, tags) with each field's text decoded by its type
        OID; raises RuntimeError on an ErrorResponse."""
        return self.typed(self.query_raw(sql))

    def typed(self, msgs):
        fields, rows, tags = [], [], []
        for tag, body in msgs:
            if tag == b"T":
                fields = row_description(body)
            elif tag == b"D":
                texts = self._parse_data_row(body)
                rows.append(tuple(decode(t, oid) for t, (_, oid)
                                  in zip(texts, fields)))
            elif tag == b"C":
                tags.append(body[:-1].decode())
            elif tag == b"E":
                raise RuntimeError(self._parse_error(body))
        return fields, rows, tags

    # ---- extended protocol, named statements ------------------------------
    def parse(self, name: str, sql: str, param_oids=()) -> None:
        body = name.encode() + b"\x00" + sql.encode() + b"\x00"
        body += struct.pack("!H", len(param_oids))
        for oid in param_oids:
            body += struct.pack("!I", oid)
        self._send(self._msg(b"P", body))

    def bind(self, statement: str, params, portal: str = "") -> None:
        body = portal.encode() + b"\x00" + statement.encode() + b"\x00"
        body += struct.pack("!H", 0) + struct.pack("!H", len(params))
        for v in params:
            if v is None:
                body += struct.pack("!i", -1)
            else:
                b = str(v).encode()
                body += struct.pack("!i", len(b)) + b
        body += struct.pack("!H", 0)
        self._send(self._msg(b"B", body))

    def describe(self, kind: str, name: str = "") -> None:
        self._send(self._msg(b"D", kind.encode() + name.encode() + b"\x00"))

    def execute(self, portal: str = "", max_rows: int = 0) -> None:
        self._send(self._msg(b"E", portal.encode() + b"\x00"
                             + struct.pack("!I", max_rows)))

    def sync(self) -> List[Tuple[bytes, bytes]]:
        self._send(self._msg(b"S"))
        return self._until_ready()

    @staticmethod
    def parameter_oids(body: bytes) -> List[int]:
        """The OIDs of a ParameterDescription body."""
        (n,) = struct.unpack_from("!H", body)
        return list(struct.unpack_from(f"!{n}I", body, 2))

    # ---- COPY ----------------------------------------------------------------
    def copy_out(self, sql: str) -> Tuple[List[str], Optional[str]]:
        """The lines of a COPY ... TO STDOUT and its command tag."""
        msgs = self.query_raw(sql)
        lines, tag = [], None
        for t, body in msgs:
            if t == b"d":
                lines.append(body.decode().rstrip("\n"))
            elif t == b"C":
                tag = body[:-1].decode()
            elif t == b"E":
                raise RuntimeError(self._parse_error(body))
        return lines, tag
