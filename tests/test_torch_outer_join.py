"""The port's outer equi-joins against the JAX package.

LEFT, RIGHT and FULL joins, with and without a residual ON condition, over
the randomized tables of tests/test_outer_residual_join.py (NULL keys on
both sides, duplicate keys), plus an empty side, both as a registered
empty table and as a derived table that filters every row away. Each query
runs through the JAX Session and the port's Session with the compiled
pipeline on and off; rows must be identical. COUNT(column) across an outer
join counts the padded side's validity, not its rows (TPC-H Q13).
"""

import numpy as np
import pytest

from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session

SEED = 0

RESIDUAL = [
    "SELECT a.k, a.x, b.y FROM a LEFT JOIN b ON a.k = b.k AND b.y > 50 "
    "ORDER BY a.k, a.x, b.y",
    "SELECT a.k, b.y FROM a RIGHT JOIN b ON a.k = b.k AND a.x >= 50 "
    "ORDER BY b.y, a.k",
    "SELECT a.k, b.y FROM a FULL JOIN b ON a.k = b.k AND a.x < b.y "
    "ORDER BY a.k, b.y",
    "SELECT a.k, b.tag FROM a LEFT JOIN b ON a.k = b.k "
    "AND b.tag LIKE 'x%' ORDER BY a.k, b.tag",
]
PLAIN = [
    "SELECT a.k, a.x, b.y FROM a LEFT JOIN b ON a.k = b.k "
    "ORDER BY a.k, a.x, b.y",
    "SELECT a.k, a.x, b.k, b.y FROM a RIGHT JOIN b ON a.k = b.k "
    "ORDER BY b.y, b.k, a.x",
    "SELECT a.k, a.x, b.k, b.y FROM a FULL JOIN b ON a.k = b.k "
    "ORDER BY a.k, a.x, b.k, b.y",
    "SELECT a.x, b.tag FROM a LEFT JOIN b ON a.k = b.k WHERE b.y IS NULL "
    "ORDER BY a.x, b.tag",
]
COUNTS = [
    "SELECT a.k, COUNT(b.y), COUNT(*), SUM(b.y) FROM a LEFT JOIN b "
    "ON a.k = b.k AND b.y > 50 GROUP BY a.k ORDER BY a.k",
    "SELECT c, COUNT(*) FROM (SELECT a.x, COUNT(b.k) AS c FROM a "
    "LEFT JOIN b ON a.k = b.k AND b.tag NOT LIKE 'x%' GROUP BY a.x) q "
    "GROUP BY c ORDER BY c",
    "SELECT COUNT(a.k), COUNT(b.k), COUNT(*) FROM a FULL JOIN b "
    "ON a.k = b.k",
]
EMPTY = [
    "SELECT a.k, a.x, e.y FROM a LEFT JOIN e ON a.k = e.k "
    "ORDER BY a.k, a.x",
    "SELECT a.k, e.y FROM a RIGHT JOIN e ON a.k = e.k ORDER BY a.k",
    "SELECT a.k, e.y FROM a FULL JOIN e ON a.k = e.k AND a.x > e.y "
    "ORDER BY a.k, a.x",
    "SELECT a.k, COUNT(e.y) FROM a LEFT JOIN e ON a.k = e.k AND e.y > 0 "
    "GROUP BY a.k ORDER BY a.k",
    "SELECT a.k, bb.y FROM a LEFT JOIN (SELECT k, y FROM b WHERE y > 1000) "
    "bb ON a.k = bb.k ORDER BY a.k, a.x",
    "SELECT bb.y, a.x FROM (SELECT k, y FROM b WHERE y > 1000) bb "
    "FULL JOIN a ON a.k = bb.k AND a.x > bb.y ORDER BY a.x",
]


def _tables(seed):
    """tests/test_outer_residual_join.py's tables (5 % NULL keys on each
    side, keys 0-39 repeated), and an empty table `e`."""
    rng = np.random.default_rng(seed)
    n, m = 300, 200
    ak = [int(v) if ok else None for v, ok in
          zip(rng.integers(0, 40, n), rng.random(n) > 0.05)]
    a = {"k": ak, "x": [int(v) for v in rng.integers(0, 100, n)]}
    bk = [int(v) if ok else None for v, ok in
          zip(rng.integers(0, 40, m), rng.random(m) > 0.05)]
    b = {"k": bk, "y": [int(v) for v in rng.integers(0, 100, m)],
         "tag": rng.choice(["xa", "xb", "yc", "yd"], m).tolist()}
    return a, b


@pytest.fixture(scope="module")
def sessions():
    from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
    from query_engine_tpu.core.schema import Field as JField
    from query_engine_tpu.core.schema import Schema as JSchema
    from query_engine_tpu.core.types import DataType as JType
    from query_engine_tpu_torch.columnar.batch import ColumnBatch
    from query_engine_tpu_torch.core.schema import Field, Schema
    from query_engine_tpu_torch.core.types import DataType

    a, b = _tables(SEED)
    js, compiled, eager = JSession(), Session("cpu"), Session("cpu")
    eager.executor._compiled = False
    for s in (js, compiled, eager):
        s.register_table("a", a)
        s.register_table("b", b)
    empty = {"k": [], "y": []}
    js.register_table("e", JBatch.from_pydict(empty, JSchema(
        [JField("k", JType.int64()), JField("y", JType.int64())])))
    for s in (compiled, eager):
        s.register_table("e", ColumnBatch.from_pydict(empty, Schema(
            [Field("k", DataType.int64()), Field("y", DataType.int64())])))
    return js, compiled, eager


def _check(sessions, query):
    js, compiled, eager = sessions
    want = js.sql(query).to_pylist()
    for s in (compiled, eager):
        assert s.sql(query).to_pylist() == want, query
    return want


@pytest.mark.parametrize("query", RESIDUAL, ids=lambda q: q[:48])
def test_outer_join_with_residual_matches_jax(sessions, query):
    _check(sessions, query)


@pytest.mark.parametrize("query", PLAIN, ids=lambda q: q[:48])
def test_outer_join_matches_jax(sessions, query):
    _check(sessions, query)


@pytest.mark.parametrize("query", COUNTS, ids=lambda q: q[:48])
def test_count_across_outer_join_matches_jax(sessions, query):
    _check(sessions, query)


@pytest.mark.parametrize("query", EMPTY, ids=lambda q: q[:48])
def test_outer_join_with_an_empty_side_matches_jax(sessions, query):
    _check(sessions, query)


@pytest.mark.parametrize("query", [q.split(" ORDER BY")[0]
                                   for q in RESIDUAL + PLAIN],
                         ids=lambda q: q[:48])
def test_outer_join_without_order_matches_jax(sessions, query):
    """Without ORDER BY, compared as multisets."""
    js, compiled, eager = sessions
    want = sorted(map(repr, js.sql(query).to_pylist()))
    for s in (compiled, eager):
        assert sorted(map(repr, s.sql(query).to_pylist())) == want


@pytest.mark.parametrize("compiled", [True, False])
def test_residual_outer_exact_rows(compiled):
    """Pairs failing the residual are not emitted, and an outer row all of
    whose pairs fail it still appears once, NULL-padded."""
    s = Session("cpu")
    s.executor._compiled = compiled
    s.register_table("a", {"k": [1, 1, 2, 3], "x": [10, 20, 30, 40]})
    s.register_table("b", {"k": [1, 1, 4], "y": [5, 100, 7]})
    rows = s.sql("SELECT a.k, a.x, b.y FROM a LEFT JOIN b "
                 "ON a.k = b.k AND b.y > 50").to_pylist()
    assert sorted(rows, key=repr) == [(1, 10, 100), (1, 20, 100),
                                      (2, 30, None), (3, 40, None)]
    rows = s.sql("SELECT a.x, b.y FROM a FULL JOIN b "
                 "ON a.k = b.k AND b.y > 50").to_pylist()
    assert sorted(rows, key=repr) == sorted(
        [(10, 100), (20, 100), (30, None), (40, None), (None, 5),
         (None, 7)], key=repr)


@pytest.mark.parametrize("compiled", [True, False])
def test_count_column_counts_valid_values_only(compiled):
    """COUNT(b.y) over a LEFT join is 0 for an unmatched row, where
    COUNT(*) is 1."""
    s = Session("cpu")
    s.executor._compiled = compiled
    s.register_table("a", {"k": [1, 2, 3]})
    s.register_table("b", {"k": [1, 1, 3], "y": [4, None, 6]})
    rows = s.sql("SELECT a.k, COUNT(b.y), COUNT(*), COUNT(b.k) FROM a "
                 "LEFT JOIN b ON a.k = b.k GROUP BY a.k "
                 "ORDER BY a.k").to_pylist()
    assert rows == [(1, 1, 2, 2), (2, 0, 1, 0), (3, 1, 1, 1)]


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
def test_shared_cte_left_joined_to_itself(compiled):
    """A WITH query referenced on both sides of a LEFT join is materialized
    once and read by both (tests/test_torch_tpch_subqueries.py counts the
    executions)."""
    s = Session("cpu")
    s.executor._compiled = compiled
    s.register_table("a", {"k": [1, 2, 3, None]})
    rows = s.sql("WITH w AS (SELECT k FROM a WHERE k < 3 OR k IS NULL) "
                 "SELECT w1.k, w2.k FROM w w1 LEFT JOIN w w2 "
                 "ON w1.k = w2.k ORDER BY w1.k").to_pylist()
    assert rows == [(1, 1), (2, 2), (None, None)]
