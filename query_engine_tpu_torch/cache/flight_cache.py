"""Flight-endpoint cache keys.

Parity surface: reference crates/query-cache/src/flight_cache.rs:13-20 —
cache key = hash(endpoint, query).
"""

from __future__ import annotations

import hashlib

from query_engine_tpu_torch.cache.cache import CacheKey


def flight_cache_key(endpoint: str, query: str) -> CacheKey:
    normalized = " ".join(query.split()).lower().rstrip(";")
    h = hashlib.sha256(f"{endpoint}\x00{normalized}".encode()).hexdigest()
    return CacheKey(h)
