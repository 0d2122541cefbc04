"""Cached query executor.

Parity surface: reference crates/query-executor/src/cached_executor.rs:13-127
— wraps QueryExecutor with an SQL-keyed LRU result cache: get -> execute ->
put; execute_with_key / execute_uncached / invalidate / clear / stats
passthrough.
"""

from __future__ import annotations

from typing import Optional

from query_engine_tpu_torch.cache.cache import CacheKey, QueryCache
from query_engine_tpu_torch.cache.config import CacheConfig
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.executor import QueryExecutor
from query_engine_tpu_torch.plan import physical as pp


class CachedQueryExecutor:
    def __init__(self, device, config: Optional[CacheConfig] = None,
                 udfs=None):
        """device: the torch device the inner executor runs on, as
        QueryExecutor takes it."""
        self.inner = QueryExecutor(device, udfs)
        self.cache = QueryCache(config)

    def execute_cached(self, sql: str, plan: pp.PhysicalPlan) -> ColumnBatch:
        """get -> execute -> put, keyed by normalized SQL."""
        return self.execute_with_key(CacheKey.from_sql(sql), plan)

    def execute_with_key(self, key: CacheKey, plan: pp.PhysicalPlan) -> ColumnBatch:
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        result = self.inner.execute(plan)
        self.cache.put(key, result)
        return result

    def execute_uncached(self, plan: pp.PhysicalPlan) -> ColumnBatch:
        return self.inner.execute(plan)

    def invalidate(self, sql: str) -> None:
        self.cache.invalidate_sql(sql)

    def clear_cache(self) -> None:
        self.cache.clear()

    @property
    def stats(self):
        return self.cache.stats
