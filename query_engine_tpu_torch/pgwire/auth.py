"""Authentication configuration.

Parity surface: reference crates/query-pgwire/src/auth.rs:50-253 —
AuthConfig user/password map, trust/cleartext/MD5 (random salt +
hash_md5_password) and SCRAM-SHA-256: the full RFC 7677 exchange is
implemented by ScramServer in pgwire/protocol.py and negotiated on the
wire (negative-password coverage in tests/test_pgwire.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict

from query_engine_tpu_torch.pgwire.protocol import md5_password


class AuthMethod(enum.Enum):
    TRUST = "trust"
    CLEARTEXT = "cleartext"
    MD5 = "md5"
    SCRAM_SHA_256 = "scram-sha-256"


@dataclass
class AuthConfig:
    method: AuthMethod = AuthMethod.TRUST
    users: Dict[str, str] = field(default_factory=dict)  # user -> password

    @staticmethod
    def trust() -> "AuthConfig":
        return AuthConfig(AuthMethod.TRUST)

    @staticmethod
    def md5(users: Dict[str, str]) -> "AuthConfig":
        return AuthConfig(AuthMethod.MD5, dict(users))

    @staticmethod
    def cleartext(users: Dict[str, str]) -> "AuthConfig":
        return AuthConfig(AuthMethod.CLEARTEXT, dict(users))

    def add_user(self, user: str, password: str) -> "AuthConfig":
        self.users[user] = password
        return self

    def verify_cleartext(self, user: str, password: str) -> bool:
        return self.users.get(user) == password

    def verify_md5(self, user: str, response: str, salt: bytes) -> bool:
        password = self.users.get(user)
        if password is None:
            return False
        return md5_password(user, password, salt) == response
