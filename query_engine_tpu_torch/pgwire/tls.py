"""TLS configuration for the pgwire server.

Parity surface: reference crates/query-pgwire/src/tls.rs:27-127 — rustls
cert/key loading -> TlsAcceptor; here: ssl.SSLContext + the PostgreSQL
STARTTLS-style upgrade (client sends SSLRequest, server answers 'S', the
socket upgrades in place).
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass

from query_engine_tpu_torch.core.errors import ExecutionError


@dataclass
class TlsConfig:
    cert_path: str
    key_path: str

    def ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        try:
            ctx.load_cert_chain(self.cert_path, self.key_path)
        except (OSError, ssl.SSLError) as e:
            raise ExecutionError(f"cannot load TLS cert/key: {e}")
        return ctx
