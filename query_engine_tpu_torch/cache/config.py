"""Cache configuration.

Parity surface: reference crates/query-cache/src/config.rs:7-71 —
max_entries=1000, max_memory=100MB, ttl=300s, enabled, chainable with_* setters.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class CacheConfig:
    max_entries: int = 1000
    max_memory_bytes: int = 100 * 1024 * 1024
    ttl_seconds: float = 300.0
    enabled: bool = True

    def with_max_entries(self, n: int) -> "CacheConfig":
        self.max_entries = n
        return self

    def with_max_memory(self, n: int) -> "CacheConfig":
        self.max_memory_bytes = n
        return self

    def with_ttl(self, secs: float) -> "CacheConfig":
        self.ttl_seconds = secs
        return self

    def disabled(self) -> "CacheConfig":
        self.enabled = False
        return self
