"""The port's result cache (`query_engine_tpu_torch/cache/`,
`engine/cached_executor.py`): the cases of tests/test_cache.py against the
port's package (key normalization, LRU, TTL, the memory cap, concurrency,
invalidation events, the Flight key, the cached executor), its byte size
read from tensor shapes, and `Session(enable_cache=True)`: a repeated
SELECT is a hit that runs no program, every DDL and DML statement clears
it, parameter values key it, and the statuses and rows equal the JAX
Session's with its cache on."""

import threading
import time

import pytest
import torch

from torch_session_diff import MODES, port_session, run_script

from query_engine_tpu_torch.cache.cache import (
    CacheEntry, CacheKey, QueryCache, batch_memory_size,
)
from query_engine_tpu_torch.cache.config import CacheConfig
from query_engine_tpu_torch.cache.flight_cache import flight_cache_key
from query_engine_tpu_torch.cache.invalidation import (
    FullClearInvalidator, InvalidationEvent, NoOpInvalidator,
)
from query_engine_tpu_torch.columnar.batch import ColumnBatch


def make_batch(n=10):
    return ColumnBatch.from_pydict({"x": list(range(n))})


def test_cache_key_normalization():
    a = CacheKey.from_sql("SELECT  *  FROM t;")
    b = CacheKey.from_sql("select * from T")
    c = CacheKey.from_sql("select * from u")
    assert a == b and a != c


def test_basic_get_put_and_stats():
    cache = QueryCache(CacheConfig())
    key = CacheKey.from_sql("select 1")
    assert cache.get(key) is None
    cache.put(key, make_batch())
    hit = cache.get(key)
    assert hit is not None and hit.num_rows == 10
    assert cache.stats.hits == 1 and cache.stats.misses == 1
    assert cache.stats.hit_rate == 0.5
    assert cache.memory_bytes > 0
    assert cache.stats.snapshot()["entry_count"] == 1


def test_ttl_expiry_and_sweep():
    cache = QueryCache(CacheConfig(ttl_seconds=0.05))
    key = CacheKey.from_sql("q")
    cache.put(key, make_batch())
    assert cache.get(key) is not None
    time.sleep(0.08)
    assert cache.get(key) is None
    assert cache.stats.expirations == 1
    cache.put(CacheKey.from_sql("q2"), make_batch())
    time.sleep(0.08)
    assert cache.expire_stale() == 1
    assert len(cache) == 0


def test_lru_eviction_by_entry_count():
    cache = QueryCache(CacheConfig(max_entries=3))
    keys = [CacheKey.from_sql(f"q{i}") for i in range(4)]
    for k in keys[:3]:
        cache.put(k, make_batch())
    cache.get(keys[0])  # touch q0 -> q1 is now LRU
    cache.put(keys[3], make_batch())
    assert cache.get(keys[1]) is None  # evicted
    assert cache.get(keys[0]) is not None
    assert cache.stats.evictions == 1


def test_memory_cap_eviction():
    one = make_batch(1000)
    size = CacheEntry(one).size_bytes
    cache = QueryCache(CacheConfig(max_memory_bytes=int(size * 2.5)))
    for i in range(3):
        cache.put(CacheKey.from_sql(f"m{i}"), make_batch(1000))
    assert len(cache) == 2
    assert cache.memory_bytes <= int(size * 2.5)


def test_disabled_cache():
    cache = QueryCache(CacheConfig().disabled())
    key = CacheKey.from_sql("x")
    cache.put(key, make_batch())
    assert cache.get(key) is None


def test_concurrent_access():
    cache = QueryCache(CacheConfig())
    errors = []

    def worker(i):
        try:
            for j in range(50):
                k = CacheKey.from_sql(f"q{i}_{j % 5}")
                cache.put(k, make_batch(5))
                cache.get(k)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_invalidation_and_flight_key():
    cache = QueryCache(CacheConfig())
    cache.put(CacheKey.from_sql("a"), make_batch())
    NoOpInvalidator().handle_event(InvalidationEvent.all())
    assert len(cache) == 1
    inv = FullClearInvalidator(cache)
    inv.handle_event(InvalidationEvent.table_modified("t"))
    assert len(cache) == 0
    k1 = flight_cache_key("grpc://h:1", "select 1")
    k2 = flight_cache_key("grpc://h:2", "select 1")
    assert k1 != k2


def test_cached_executor_roundtrip():
    from query_engine_tpu_torch.engine.cached_executor import (
        CachedQueryExecutor,
    )
    from query_engine_tpu_torch.engine.executor import _Materialized

    ex = CachedQueryExecutor("cpu")
    plan = _Materialized(make_batch(7))
    out1 = ex.execute_cached("SELECT * FROM t7", plan)
    out2 = ex.execute_cached("select * from T7", plan)
    assert out1.num_rows == out2.num_rows == 7
    assert ex.stats.hits == 1
    ex.invalidate("select * from t7")
    assert ex.execute_uncached(plan).num_rows == 7
    ex.clear_cache()
    assert len(ex.cache) == 0


def test_memory_size_reads_shapes_only():
    """The byte size comes from numel * element_size: no plane is copied
    (a meta tensor has no data to copy)."""
    b = ColumnBatch.from_pydict({"x": [1, 2, 3], "s": ["a", "bb", "a"]})
    want = sum(c.data.numel() * c.data.element_size()
               + c.validity.numel() for c in b.columns) + len("a") + len("bb")
    assert batch_memory_size(b) == want
    for c in b.columns:
        c.data = torch.empty_like(c.data, device="meta")
        c.validity = torch.empty_like(c.validity, device="meta")
    assert batch_memory_size(b) == want


def test_session_cache_invalidated_by_dml():
    s = port_session("compiled", enable_cache=True)
    s.sql("CREATE TABLE t (id INT)")
    s.sql("INSERT INTO t (id) VALUES (1)")
    assert s.sql("SELECT COUNT(*) FROM t").to_pylist() == [(1,)]
    s.sql("INSERT INTO t (id) VALUES (2)")
    assert s.sql("SELECT COUNT(*) FROM t").to_pylist() == [(2,)]


def test_session_cache_hit_runs_no_program():
    s = port_session("compiled", enable_cache=True)
    s.register_table("t", {"k": [1, 2, 1, 3], "v": [1.5, 2.5, 3.5, 4.5]})
    q = "SELECT k, SUM(v) FROM t GROUP BY k ORDER BY k"
    first = s.sql(q)
    stats, syncs = dict(s.executor.pipeline.stats), s.executor.host_syncs
    again = s.sql(q)
    assert again is first
    assert s.executor.pipeline.stats == stats
    assert s.executor.host_syncs == syncs
    assert s._cache.stats.hits == 1
    # the same text with other parameter values is another entry
    assert s.sql("SELECT v FROM t WHERE k = $1 ORDER BY v", [1]).to_pylist() \
        == [(1.5,), (3.5,)]
    assert s.sql("SELECT v FROM t WHERE k = $1 ORDER BY v", [3]).to_pylist() \
        == [(4.5,)]
    s.sql("UPDATE t SET v = 0 WHERE k = 1")
    assert len(s._cache) == 0
    assert s.sql(q).to_pylist() == [(1, 0.0), (2, 2.5), (3, 4.5)]


CACHED = [
    "CREATE TABLE t (id INT, v TEXT)",
    "INSERT INTO t VALUES (1, 'a'), (2, 'b')",
    "SELECT * FROM t ORDER BY id",
    "SELECT * FROM t ORDER BY id",
    "UPDATE t SET v = 'z' WHERE id = 1",
    "SELECT * FROM t ORDER BY id",
    "CREATE VIEW tv AS SELECT COUNT(*) AS c FROM t",
    "SELECT c FROM tv",
    "DELETE FROM t WHERE id = 2",
    "SELECT c FROM tv",
    "ALTER TABLE t ADD COLUMN w INT",
    "SELECT * FROM t ORDER BY id",
    "BEGIN",
    "INSERT INTO t VALUES (3, 'c', 3)",
    "SELECT * FROM t ORDER BY id",
    "ROLLBACK",
    "SELECT * FROM t ORDER BY id",
    "TRUNCATE TABLE t",
    "SELECT * FROM t ORDER BY id",
    "DROP VIEW tv",
    "SELECT c FROM tv",
]


@pytest.mark.parametrize("mode", MODES)
def test_session_cache_matches_jax(mode):
    """The statuses and rows of a script with repeated SELECTs between
    DDL, DML and a ROLLBACK equal the JAX Session's, both caches on."""
    js, ts, _ = run_script(CACHED, mode, jax_kwargs={"enable_cache": True},
                           port_kwargs={"enable_cache": True})
    assert ts._cache.stats.hits == js._cache.stats.hits > 0
