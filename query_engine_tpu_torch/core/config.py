"""Server / endpoint configuration.

Parity surface: reference crates/query-core/src/flight.rs:9-114
(`FlightConfig` host/port/TLS/max_connections/timeout, `FlightEndpoint`
url/auth_token/verify_tls).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class FlightConfig:
    host: str = "0.0.0.0"
    port: int = 50051
    enable_tls: bool = False
    tls_cert_path: Optional[str] = None
    tls_key_path: Optional[str] = None
    max_connections: int = 100
    timeout_seconds: int = 60

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def with_host(self, host: str) -> "FlightConfig":
        self.host = host
        return self

    def with_port(self, port: int) -> "FlightConfig":
        self.port = port
        return self


@dataclass
class FlightEndpoint:
    url: str
    auth_token: Optional[str] = None
    verify_tls: bool = True
    headers: dict = field(default_factory=dict)

    @staticmethod
    def new(url: str) -> "FlightEndpoint":
        return FlightEndpoint(url=url)

    def with_auth_token(self, token: str) -> "FlightEndpoint":
        self.auth_token = token
        return self
