"""Query result cache: thread-safe LRU with TTL + memory cap.

Parity surface: reference crates/query-cache/src/cache.rs:16-337 —
CacheKey::from_sql (hash of normalized SQL, :23-51), CacheEntry (batches +
created_at + size via get_array_memory_size, :89-101), LRU with TTL expiry,
byte-size memory cap with LRU eviction loop (:195-217), expire_stale sweep
(:312-336).
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from query_engine_tpu_torch.cache.config import CacheConfig
from query_engine_tpu_torch.cache.stats import CacheStats
from query_engine_tpu_torch.columnar.batch import ColumnBatch


@dataclass(frozen=True)
class CacheKey:
    """Hash of the (whitespace-normalized, lowercased) SQL text."""

    hash: str

    @staticmethod
    def from_sql(sql: str) -> "CacheKey":
        normalized = " ".join(sql.split()).lower().rstrip(";")
        return CacheKey(hashlib.sha256(normalized.encode()).hexdigest())


def batch_memory_size(batch: ColumnBatch) -> int:
    """Device-plane byte size (Arrow get_array_memory_size analog), read
    from the tensors' shapes: nothing is copied off the device."""
    total = 0
    for c in batch.columns:
        total += c.data.numel() * c.data.element_size() \
            + c.validity.numel() * c.validity.element_size()
        if c.dictionary is not None:
            total += sum(len(str(v)) for v in c.dictionary.values)
    return total


@dataclass
class CacheEntry:
    batch: ColumnBatch
    created_at: float = field(default_factory=time.time)
    size_bytes: int = 0

    def __post_init__(self):
        if self.size_bytes == 0:
            self.size_bytes = batch_memory_size(self.batch)

    def is_expired(self, ttl: float, now: Optional[float] = None) -> bool:
        now = now if now is not None else time.time()
        return (now - self.created_at) > ttl


class QueryCache:
    def __init__(self, config: Optional[CacheConfig] = None):
        self.config = config or CacheConfig()
        self._entries: "OrderedDict[CacheKey, CacheEntry]" = OrderedDict()
        self._memory = 0
        self._lock = threading.RLock()
        self.stats = CacheStats()

    # ---- core ----------------------------------------------------------
    def get(self, key: CacheKey) -> Optional[ColumnBatch]:
        if not self.config.enabled:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.record_miss()
                return None
            if entry.is_expired(self.config.ttl_seconds):
                self._remove(key)
                self.stats.record_expiration()
                self.stats.record_miss()
                return None
            self._entries.move_to_end(key)  # LRU touch
            self.stats.record_hit()
            return entry.batch

    def put(self, key: CacheKey, batch: ColumnBatch) -> None:
        if not self.config.enabled:
            return
        entry = CacheEntry(batch)
        with self._lock:
            if key in self._entries:
                self._remove(key)
            # memory cap: evict LRU until it fits (cache.rs:195-217)
            while (
                self._entries
                and (
                    self._memory + entry.size_bytes > self.config.max_memory_bytes
                    or len(self._entries) >= self.config.max_entries
                )
            ):
                old_key, _ = next(iter(self._entries.items()))
                self._remove(old_key)
                self.stats.record_eviction()
            if entry.size_bytes > self.config.max_memory_bytes:
                return  # single entry larger than the cache: skip
            self._entries[key] = entry
            self._memory += entry.size_bytes
            self.stats.set_entries(len(self._entries), self._memory)

    def _remove(self, key: CacheKey) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._memory -= entry.size_bytes
            self.stats.set_entries(len(self._entries), self._memory)

    # ---- SQL-level convenience -----------------------------------------
    def get_sql(self, sql: str) -> Optional[ColumnBatch]:
        return self.get(CacheKey.from_sql(sql))

    def put_sql(self, sql: str, batch: ColumnBatch) -> None:
        self.put(CacheKey.from_sql(sql), batch)

    def invalidate(self, key: CacheKey) -> None:
        with self._lock:
            self._remove(key)

    def invalidate_sql(self, sql: str) -> None:
        self.invalidate(CacheKey.from_sql(sql))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._memory = 0
            self.stats.set_entries(0, 0)

    def expire_stale(self) -> int:
        """Sweep expired entries (cache.rs:312-336)."""
        now = time.time()
        with self._lock:
            stale = [
                k for k, e in self._entries.items()
                if e.is_expired(self.config.ttl_seconds, now)
            ]
            for k in stale:
                self._remove(k)
            if stale:
                self.stats.record_expiration(len(stale))
            return len(stale)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def memory_bytes(self) -> int:
        return self._memory
