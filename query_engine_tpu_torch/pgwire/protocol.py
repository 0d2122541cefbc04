"""PostgreSQL wire protocol v3: message framing + codecs.

Parity surface: the protocol machinery the reference gets from the `pgwire`
crate (crates/query-pgwire uses pgwire 0.28); here it is implemented
directly — startup/SSL negotiation, authentication (trust/cleartext/MD5),
simple query, extended query (Parse/Bind/Describe/Execute/Sync/Close),
COPY sub-protocol, and error responses.
"""

from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

PROTOCOL_VERSION = 196608  # 3.0
SSL_REQUEST = 80877103
CANCEL_REQUEST = 80877102
GSSENC_REQUEST = 80877104


# ---------------------------------------------------------------------------
# low-level framing
# ---------------------------------------------------------------------------


def encode_message(tag: bytes, payload: bytes = b"") -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def cstr(s: str) -> bytes:
    return s.encode("utf-8") + b"\x00"


def read_cstr(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("utf-8"), end + 1


# ---------------------------------------------------------------------------
# backend (server -> client) messages
# ---------------------------------------------------------------------------


def auth_ok() -> bytes:
    return encode_message(b"R", struct.pack("!I", 0))


def auth_cleartext() -> bytes:
    return encode_message(b"R", struct.pack("!I", 3))


def auth_md5(salt: bytes) -> bytes:
    return encode_message(b"R", struct.pack("!I", 5) + salt)


def parameter_status(name: str, value: str) -> bytes:
    return encode_message(b"S", cstr(name) + cstr(value))


def backend_key_data(pid: int, secret: int) -> bytes:
    return encode_message(b"K", struct.pack("!II", pid, secret))


def ready_for_query(status: bytes = b"I") -> bytes:
    return encode_message(b"Z", status)


@dataclass
class FieldInfo:
    name: str
    type_oid: int
    type_size: int = -1
    type_modifier: int = -1
    format_code: int = 0  # text
    table_oid: int = 0
    column_id: int = 0


def row_description(fields: List[FieldInfo]) -> bytes:
    payload = struct.pack("!H", len(fields))
    for f in fields:
        payload += cstr(f.name)
        payload += struct.pack(
            "!IHIhih",
            f.table_oid, f.column_id, f.type_oid,
            f.type_size, f.type_modifier, f.format_code,
        )
    return encode_message(b"T", payload)


def data_row(values: List[Optional[bytes]]) -> bytes:
    payload = struct.pack("!H", len(values))
    for v in values:
        if v is None:
            payload += struct.pack("!i", -1)
        else:
            payload += struct.pack("!i", len(v)) + v
    return encode_message(b"D", payload)


def command_complete(tag: str) -> bytes:
    return encode_message(b"C", cstr(tag))


def empty_query_response() -> bytes:
    return encode_message(b"I")


def parse_complete() -> bytes:
    return encode_message(b"1")


def bind_complete() -> bytes:
    return encode_message(b"2")


def close_complete() -> bytes:
    return encode_message(b"3")


def no_data() -> bytes:
    return encode_message(b"n")


def portal_suspended() -> bytes:
    return encode_message(b"s")


def parameter_description(oids: List[int]) -> bytes:
    payload = struct.pack("!H", len(oids))
    for oid in oids:
        payload += struct.pack("!I", oid)
    return encode_message(b"t", payload)


def error_response(message: str, code: str = "42601",
                   severity: str = "ERROR") -> bytes:
    payload = (
        b"S" + cstr(severity) + b"V" + cstr(severity)
        + b"C" + cstr(code) + b"M" + cstr(message) + b"\x00"
    )
    return encode_message(b"E", payload)


def notice_response(message: str) -> bytes:
    payload = (
        b"S" + cstr("NOTICE") + b"C" + cstr("00000") + b"M" + cstr(message)
        + b"\x00"
    )
    return encode_message(b"N", payload)


def copy_in_response(n_cols: int) -> bytes:
    payload = struct.pack("!b", 0) + struct.pack("!H", n_cols)
    payload += struct.pack(f"!{n_cols}H", *([0] * n_cols))
    return encode_message(b"G", payload)


def copy_out_response(n_cols: int) -> bytes:
    payload = struct.pack("!b", 0) + struct.pack("!H", n_cols)
    payload += struct.pack(f"!{n_cols}H", *([0] * n_cols))
    return encode_message(b"H", payload)


def copy_data(data: bytes) -> bytes:
    return encode_message(b"d", data)


def copy_done() -> bytes:
    return encode_message(b"c")


# ---------------------------------------------------------------------------
# frontend (client -> server) message parsing
# ---------------------------------------------------------------------------


@dataclass
class StartupMessage:
    protocol: int
    params: Dict[str, str]


def parse_startup(payload: bytes) -> StartupMessage:
    protocol = struct.unpack("!I", payload[:4])[0]
    params: Dict[str, str] = {}
    pos = 4
    while pos < len(payload) - 1:
        key, pos = read_cstr(payload, pos)
        if not key:
            break
        val, pos = read_cstr(payload, pos)
        params[key] = val
    return StartupMessage(protocol, params)


@dataclass
class ParseMessage:
    name: str
    query: str
    param_oids: List[int]


def parse_parse(payload: bytes) -> ParseMessage:
    name, pos = read_cstr(payload, 0)
    query, pos = read_cstr(payload, pos)
    (n,) = struct.unpack_from("!H", payload, pos)
    pos += 2
    oids = list(struct.unpack_from(f"!{n}I", payload, pos)) if n else []
    return ParseMessage(name, query, oids)


@dataclass
class BindMessage:
    portal: str
    statement: str
    param_formats: List[int]
    params: List[Optional[bytes]]
    result_formats: List[int]


def parse_bind(payload: bytes) -> BindMessage:
    portal, pos = read_cstr(payload, 0)
    statement, pos = read_cstr(payload, pos)
    (nf,) = struct.unpack_from("!H", payload, pos)
    pos += 2
    formats = list(struct.unpack_from(f"!{nf}H", payload, pos)) if nf else []
    pos += 2 * nf
    (np_,) = struct.unpack_from("!H", payload, pos)
    pos += 2
    params: List[Optional[bytes]] = []
    for _ in range(np_):
        (ln,) = struct.unpack_from("!i", payload, pos)
        pos += 4
        if ln == -1:
            params.append(None)
        else:
            params.append(payload[pos: pos + ln])
            pos += ln
    (nr,) = struct.unpack_from("!H", payload, pos)
    pos += 2
    rformats = list(struct.unpack_from(f"!{nr}H", payload, pos)) if nr else []
    return BindMessage(portal, statement, formats, params, rformats)


@dataclass
class DescribeMessage:
    kind: str  # 'S' statement | 'P' portal
    name: str


def parse_describe(payload: bytes) -> DescribeMessage:
    kind = chr(payload[0])
    name, _ = read_cstr(payload, 1)
    return DescribeMessage(kind, name)


@dataclass
class ExecuteMessage:
    portal: str
    max_rows: int


def parse_execute(payload: bytes) -> ExecuteMessage:
    portal, pos = read_cstr(payload, 0)
    (max_rows,) = struct.unpack_from("!I", payload, pos)
    return ExecuteMessage(portal, max_rows)


def parse_close(payload: bytes) -> DescribeMessage:
    return parse_describe(payload)


def auth_sasl(mechanisms=("SCRAM-SHA-256",)) -> bytes:
    payload = struct.pack("!I", 10)
    for m in mechanisms:
        payload += cstr(m)
    payload += b"\x00"
    return encode_message(b"R", payload)


def auth_sasl_continue(data: bytes) -> bytes:
    return encode_message(b"R", struct.pack("!I", 11) + data)


def auth_sasl_final(data: bytes) -> bytes:
    return encode_message(b"R", struct.pack("!I", 12) + data)


# ---------------------------------------------------------------------------
# SCRAM-SHA-256 (RFC 5802/7677; reference auth.rs:186-209 SCRAM handler)
# ---------------------------------------------------------------------------

import base64
import hmac as _hmac
import secrets


def _hmac256(key: bytes, msg: bytes) -> bytes:
    return _hmac.new(key, msg, hashlib.sha256).digest()


def _h256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


class ScramServer:
    """Server-side SCRAM-SHA-256 exchange for one connection."""

    def __init__(self, password: str, iterations: int = 4096):
        self.password = password
        self.iterations = iterations
        self.salt = os.urandom(16)
        self.server_nonce = base64.b64encode(secrets.token_bytes(18)).decode()
        self.client_first_bare = ""
        self.server_first = ""
        self.nonce = ""

    def handle_client_first(self, client_first: str) -> str:
        """Returns the server-first message."""
        # client-first-message: gs2-header "n,," + bare "n=user,r=nonce"
        bare = client_first.split(",", 2)[2]
        self.client_first_bare = bare
        attrs = dict(p.split("=", 1) for p in bare.split(",") if "=" in p)
        client_nonce = attrs.get("r", "")
        self.nonce = client_nonce + self.server_nonce
        self.server_first = (
            f"r={self.nonce},s={base64.b64encode(self.salt).decode()},"
            f"i={self.iterations}"
        )
        return self.server_first

    def verify_client_final(self, client_final: str):
        """Returns server-final message ('v=...') or None on failure."""
        parts = dict(
            p.split("=", 1) for p in client_final.split(",") if "=" in p
        )
        if parts.get("r") != self.nonce:
            return None
        proof = base64.b64decode(parts.get("p", ""))
        without_proof = client_final.rsplit(",p=", 1)[0]
        auth_message = ",".join(
            [self.client_first_bare, self.server_first, without_proof]
        ).encode()
        salted = hashlib.pbkdf2_hmac(
            "sha256", self.password.encode(), self.salt, self.iterations
        )
        client_key = _hmac256(salted, b"Client Key")
        stored_key = _h256(client_key)
        signature = _hmac256(stored_key, auth_message)
        recovered = bytes(a ^ b for a, b in zip(proof, signature))
        if _h256(recovered) != stored_key:
            return None
        server_key = _hmac256(salted, b"Server Key")
        server_sig = _hmac256(server_key, auth_message)
        return "v=" + base64.b64encode(server_sig).decode()


# ---------------------------------------------------------------------------
# MD5 auth (reference auth.rs:139-171 hash_md5_password)
# ---------------------------------------------------------------------------


def md5_password(user: str, password: str, salt: bytes) -> str:
    inner = hashlib.md5((password + user).encode()).hexdigest()
    outer = hashlib.md5(inner.encode() + salt).hexdigest()
    return "md5" + outer


def random_salt() -> bytes:
    return os.urandom(4)
