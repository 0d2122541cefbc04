"""WITH RECURSIVE in the port against the JAX package.

tests/test_e2e_queries.py's recursive CTE, UNION and UNION ALL recursions
(a UNION that stops because a round finds no new row, a graph walk over a
cycle), a CTE column list, string columns that grow every round, a join of
the recursion's result with a table, a recursion that reaches the
1000-round cap, and the forms that raise (a name that shadows a table,
two CTEs, no UNION, a column list of the wrong arity, EXPLAIN) run
through the JAX Session and the port's `Session(device="cpu")`: with the
compiled pipeline on, with it off (QE_COMPILED=0), and with the pipeline
admitting nodes as on CUDA (`_graphs = True`, `_capture` stubbed). Rows
must be equal and in the same order; where the JAX package raises, the
port raises the same error class. The temporary table is gone after every
query, also after one that fails.
"""

import os

import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine import session as session_mod
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import oracle

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def _register(s):
    s.register_csv("employees", os.path.join(DATA, "employees.csv"))
    s.register_table("edges", {"parent": [1, 1, 2, 3, 4, 5, 6],
                               "child": [2, 3, 4, 4, 5, 2, 7]})
    s.register_table("li", {"qty": [1, 2, 2, 3, 5, 5, 5, 9],
                            "price": [1.5, 2.0, 2.25, 3.0, 0.5, 0.25, 4.0,
                                      9.0]})
    s.register_table("nums", {"n": [1]})


CASES = [
    # tests/test_e2e_queries.py
    "WITH RECURSIVE nums2(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM nums2 "
    "WHERE n < 5) SELECT n FROM nums2 ORDER BY n",
    # UNION: stops when a round adds no new row
    "WITH RECURSIVE r(n) AS (SELECT 1 UNION SELECT (n + 1) % 4 FROM r) "
    "SELECT n FROM r ORDER BY n",
    "WITH RECURSIVE reach(node) AS (SELECT 1 UNION SELECT e.child FROM edges "
    "e JOIN reach r ON e.parent = r.node) SELECT node FROM reach "
    "ORDER BY node",
    # UNION ALL over the same walk: a row per path, round the cycle
    # 2 -> 4 -> 5 -> 2 until depth 6
    "WITH RECURSIVE walk(node, depth) AS (SELECT 1, 0 UNION ALL "
    "SELECT e.child, w.depth + 1 FROM edges e JOIN walk w "
    "ON e.parent = w.node WHERE w.depth < 6) "
    "SELECT depth, COUNT(*), MIN(node), MAX(node) FROM walk GROUP BY depth "
    "ORDER BY depth",
    # a CTE column list of two columns
    "WITH RECURSIVE fib(a, b) AS (SELECT 0, 1 UNION ALL SELECT b, a + b "
    "FROM fib WHERE b < 100) SELECT a, b FROM fib ORDER BY a",
    # strings that grow every round (the dictionaries merge)
    "WITH RECURSIVE s(x, d) AS (SELECT 'a', 1 UNION ALL SELECT x || 'b', "
    "d + 1 FROM s WHERE d < 4) SELECT x, d FROM s ORDER BY d",
    # joined to a table and aggregated, as O6 of tpch/ordered.py
    "WITH RECURSIVE q(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM q "
    "WHERE n < 6) SELECT q.n, COUNT(*) AS c, SUM(li.price) AS s "
    "FROM q JOIN li ON li.qty = q.n GROUP BY q.n ORDER BY q.n",
    # a float column, a derived table and a filter on the result
    "WITH RECURSIVE h(k, v) AS (SELECT 1, 1.0 UNION ALL SELECT k + 1, v / 2 "
    "FROM h WHERE k < 10) SELECT k, v FROM (SELECT k, v FROM h "
    "WHERE v < 0.1) d ORDER BY k DESC",
    # reaches the 1000-round cap
    "WITH RECURSIVE r(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM r) "
    "SELECT COUNT(*), MAX(n), SUM(n) FROM r",
]

# the JAX package raises these; the port must raise the same class
RAISING = [
    # the CTE's name shadows a registered table
    "WITH RECURSIVE nums(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM nums "
    "WHERE n < 5) SELECT n FROM nums",
    # exactly one CTE
    "WITH RECURSIVE a(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM a "
    "WHERE n < 3), b(m) AS (SELECT 2) SELECT n FROM a",
    # no UNION
    "WITH RECURSIVE a(n) AS (SELECT n FROM a) SELECT n FROM a",
    # a column list of the wrong arity
    "WITH RECURSIVE a(n, m) AS (SELECT 1 UNION ALL SELECT n + 1 FROM a "
    "WHERE n < 3) SELECT n FROM a",
    # a step that fails after the first round
    "WITH RECURSIVE a(n) AS (SELECT 1 UNION ALL SELECT nope FROM a) "
    "SELECT n FROM a",
    "EXPLAIN WITH RECURSIVE a(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM a "
    "WHERE n < 3) SELECT n FROM a",
    # no column list: the step cannot name the base's column
    "WITH RECURSIVE c AS (SELECT 1 AS n UNION ALL SELECT n + 1 FROM c "
    "WHERE n < 3) SELECT n FROM c ORDER BY n",
    # a join without an equi-key in the step
    "WITH RECURSIVE s(x) AS (SELECT name FROM employees WHERE id = 1 UNION "
    "SELECT e.name FROM employees e JOIN s ON e.name > s.x) "
    "SELECT x FROM s ORDER BY x",
]


def _run(s, sql):
    try:
        return s.sql(sql).to_pylist()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__


@pytest.fixture(scope="module")
def jax_results():
    js = JSession()
    _register(js)
    return {sql: _run(js, sql) for sql in CASES + RAISING}


MODES = ["compiled", "QE_COMPILED=0", "graphs"]


def _session(mode):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
    _register(s)
    return s


@pytest.fixture(scope="module")
def sessions():
    return {mode: _session(mode) for mode in MODES}


TEMP = {"nums2", "r", "reach", "walk", "fib", "c", "s", "q", "h", "a"}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", CASES, ids=range(len(CASES)))
def test_case_matches_jax(jax_results, sessions, sql, mode):
    want = jax_results[sql]
    assert not isinstance(want, str), want
    s = sessions[mode]
    oracle.compare(s.sql(sql).to_pylist(), want)
    assert not TEMP & set(s.sources), set(s.sources)
    assert s.executor.pipeline.stats["fallbacks"] == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", RAISING, ids=range(len(RAISING)))
def test_case_raises_as_in_jax(jax_results, sessions, sql, mode):
    want = jax_results[sql]
    assert isinstance(want, str) and want != "NotImplementedError", want
    s = sessions[mode]
    assert _run(s, sql) == want
    # the temporary table is gone; a shadowed table is still there
    assert not TEMP & set(s.sources), set(s.sources)
    assert s.sql("SELECT n FROM nums").to_pylist() == [(1,)]


def test_golden_rows(jax_results):
    assert jax_results[CASES[0]] == [(1,), (2,), (3,), (4,), (5,)]
    assert jax_results[CASES[1]] == [(0,), (1,), (2,), (3,)]
    # the reference's UNION drops a round's rows seen in EARLIER rounds,
    # not the duplicates within the round: 4 (from 2 and from 3) and then
    # 5 come twice, where PostgreSQL gives each node once
    assert jax_results[CASES[2]] == [(1,), (2,), (3,), (4,), (4,), (5,),
                                     (5,)]
    assert jax_results[CASES[-1]] == [(1001, 1001, 501501)]


def test_rounds_and_frontier_device(monkeypatch):
    """The cap is MAX_RECURSION_ITERS rounds; each round's frontier is a
    table on the session's device, registered and dropped again."""
    s = _session("compiled")
    s.sql(CASES[-1]).to_pylist()
    assert s.recursion["iterations"] == session_mod.MAX_RECURSION_ITERS
    devices = []
    real = Session.register_table

    def spy(self, name, data):
        src = real(self, name, data)
        devices.append({c.data.device.type for c in src.scan().columns})
        return src

    monkeypatch.setattr(Session, "register_table", spy)
    assert s.sql(CASES[0]).to_pylist() == [(1,), (2,), (3,), (4,), (5,)]
    assert s.recursion["iterations"] == 5
    # five rounds, then the final result
    assert devices == [{"cpu"}] * 6
    s.sql(CASES[1]).to_pylist()
    assert s.recursion["iterations"] == 4
    assert s.recursion["dedup_ms"] > 0
