"""Cache statistics.

Parity surface: reference crates/query-cache/src/stats.rs:7-124 — atomic
hit/miss/eviction/expiration/entry-count/memory counters and hit_rate.
"""

from __future__ import annotations

import threading


class CacheStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.entry_count = 0
        self.memory_bytes = 0

    def record_hit(self):
        with self._lock:
            self.hits += 1

    def record_miss(self):
        with self._lock:
            self.misses += 1

    def record_eviction(self, n: int = 1):
        with self._lock:
            self.evictions += n

    def record_expiration(self, n: int = 1):
        with self._lock:
            self.expirations += n

    def set_entries(self, count: int, memory: int):
        with self._lock:
            self.entry_count = count
            self.memory_bytes = memory

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset(self):
        with self._lock:
            self.hits = self.misses = self.evictions = 0
            self.expirations = self.entry_count = self.memory_bytes = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "expirations": self.expirations,
                "entry_count": self.entry_count,
                "memory_bytes": self.memory_bytes,
                "hit_rate": self.hit_rate,
            }
