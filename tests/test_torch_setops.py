"""DISTINCT, set operations, VALUES, the empty relation, generate_series and
CROSS joins in the port against the JAX package, through both Sessions.

The set-operation, DISTINCT, VALUES and CROSS cases of
tests/test_e2e_queries.py and tests/test_edge_cases.py, every case of
tests/test_generate_series.py, and string set operations over two
dictionaries run on the same tables through the JAX Session and the port's
`Session(device="cpu")`: with the compiled pipeline on, with it off
(QE_COMPILED=0), and with the pipeline admitting nodes as on CUDA
(`_graphs = True`, `_capture` stubbed), where a set operation over strings
must run as an eager leaf (its dictionaries merge on the host) and nothing
merges dictionaries inside a program body. Rows must be equal and in the
same order: integers and strings exactly, floats to rtol 1e-9. Where the
JAX package raises, the port raises the same error class. Two parser
behaviours that both packages share are held as they are: a chain
`a UNION b UNION ALL c` gives `a UNION ALL c`, and an ORDER BY after
`a EXCEPT b` binds to b's SELECT.
"""

import os

import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.core.schema import Field as JField
from query_engine_tpu.core.schema import Schema as JSchema
from query_engine_tpu.core.types import DataType as JDataType
from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType
from query_engine_tpu_torch.engine import pipeline
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import oracle

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def _register(s, fixture, jax_side):
    if fixture == "csv":
        for name in ("employees", "departments"):
            s.register_csv(name, os.path.join(DATA, f"{name}.csv"))
    elif fixture == "edge":
        # tests/test_edge_cases.py: an empty table, all-NULL keys, one row
        if jax_side:
            schema = JSchema([JField("k", JDataType.int64()),
                              JField("v", JDataType.int64())])
            s.register_table("e", JBatch.empty(schema))
        else:
            schema = Schema([Field("k", DataType.int64()),
                             Field("v", DataType.int64())])
            s.register_table("e", ColumnBatch.empty(schema))
        s.register_table("nul", {"k": [None, None, None],
                                 "v": [None, 1, None]})
        s.register_table("one", {"k": [5], "v": [10]})
    elif fixture == "kv":
        s.register_table("t", {
            "id": list(range(100)),
            "k": [i % 7 for i in range(100)],
            "v": [i * 3 % 11 for i in range(100)],
        })
        s.register_table("x", {"a": [2, 4, 5]})
    elif fixture == "strings":
        s.register_table("a", {"s": ["pear", "fig", None, "apple", "fig",
                                     "kiwi", None],
                               "n": [1, 2, 3, 4, 2, 6, 3]})
        s.register_table("b", {"s": ["fig", "plum", None, "kiwi", "date"],
                               "n": [2, 9, 3, 5, 1]})
    elif fixture != "none":
        raise ValueError(fixture)


CASES = [
    # tests/test_e2e_queries.py
    ("csv", "SELECT e.name, d.dept_name FROM employees e CROSS JOIN "
            "departments d"),
    ("csv", "SELECT DISTINCT dept_id FROM employees ORDER BY dept_id"),
    ("csv", "SELECT dept_id FROM employees WHERE dept_id = 101 "
            "UNION ALL SELECT dept_id FROM departments WHERE dept_id = 101"),
    ("csv", "SELECT dept_id FROM employees WHERE dept_id = 101 "
            "UNION SELECT dept_id FROM departments WHERE dept_id = 101"),
    ("csv", "SELECT 1 + 2, 'hi'"),
    ("csv", "SELECT DATE '2020-01-02' AS d"),
    ("none", "SELECT a, b FROM (VALUES (1, 'x'), (2, 'y')) AS v(a, b) "
             "ORDER BY a"),
    ("none", "VALUES (1, 'one'), (2, 'two') ORDER BY 1 DESC"),
    ("none", "SELECT * FROM (VALUES (1), (2.5)) AS v(x)"),
    ("none", "SELECT * FROM (VALUES (1, NULL), (2, 'b')) AS v(a, b) "
             "ORDER BY a"),
    ("kv", "SELECT t.v, m.name FROM t JOIN (VALUES (1, 'one'), (2, 'two')) "
           "AS m(g, name) ON t.k = m.g ORDER BY t.v, m.name"),
    ("none", "SELECT * FROM (VALUES (1, 2, 10)) AS a(x, y, p) "
             "JOIN (VALUES (1, 2, 20)) AS b(x, y, q) USING (x, y)"),
    # tests/test_edge_cases.py
    ("edge", "SELECT DISTINCT k FROM nul"),
    ("edge", "SELECT * FROM e UNION SELECT * FROM one"),
    ("edge", "SELECT k FROM e INTERSECT SELECT k FROM one"),
    ("edge", "SELECT k FROM one EXCEPT SELECT k FROM e"),
    ("kv", "SELECT k, v FROM t WHERE k < 3 UNION ALL "
           "SELECT k, v FROM t WHERE v = 1"),
    # tests/test_generate_series.py
    ("none", "SELECT * FROM GENERATE_SERIES(1, 5)"),
    ("none", "SELECT i FROM GENERATE_SERIES(0, 10, 5) AS g(i)"),
    ("none", "SELECT * FROM GENERATE_SERIES(5, 1, -2)"),
    ("none", "SELECT * FROM GENERATE_SERIES(3, 1)"),
    ("none", "SELECT * FROM GENERATE_SERIES(1, 3, -1)"),
    ("none", "SELECT * FROM GENERATE_SERIES(-2, 1)"),
    ("none", "SELECT SUM(i), COUNT(*) FROM GENERATE_SERIES(1, 100) g(i)"),
    ("kv", "SELECT a FROM x WHERE a IN "
           "(SELECT i FROM GENERATE_SERIES(0, 10, 4) g(i)) ORDER BY a"),
    ("none", "SELECT * FROM GENERATE_SERIES(DATE '2024-01-29', "
             "DATE '2024-02-03', INTERVAL '2 days')"),
    ("none", "SELECT * FROM GENERATE_SERIES(DATE '2024-01-31', "
             "DATE '2024-04-30', INTERVAL '1 month')"),
    ("none", "SELECT * FROM GENERATE_SERIES(TIMESTAMP '2024-01-01 00:00:00',"
             " TIMESTAMP '2024-01-01 03:00:00', INTERVAL '90 minutes')"),
    ("none", "SELECT * FROM GENERATE_SERIES(DATE '2024-03-01', "
             "DATE '2024-01-01', INTERVAL '-1 month')"),
    ("none", "SELECT i % 3 AS m, COUNT(*) AS c FROM GENERATE_SERIES(1, 999) "
             "g(i) GROUP BY i % 3 ORDER BY m"),
    ("none", "SELECT EXTRACT(month FROM d) AS m, COUNT(*) AS c "
             "FROM GENERATE_SERIES(DATE '2024-01-01', DATE '2024-03-31', "
             "INTERVAL '1 day') g(d) GROUP BY EXTRACT(month FROM d) "
             "ORDER BY m"),
    # DISTINCT ON and over expressions, set operations over strings (two
    # dictionaries) and NULLs, CROSS joins under a filter
    ("csv", "SELECT DISTINCT ON (dept_id) name, dept_id FROM employees "
            "ORDER BY dept_id, name"),
    ("csv", "SELECT DISTINCT age > 29, dept_id IS NULL FROM employees"),
    ("csv", "SELECT dept_id FROM employees EXCEPT SELECT dept_id "
            "FROM departments"),
    ("csv", "SELECT e.name, d.dept_name FROM employees e, departments d "
            "WHERE e.age > d.dept_id - 75 ORDER BY 1, 2"),
    ("csv", "SELECT d.dept_name, COUNT(*) FROM employees e CROSS JOIN "
            "departments d GROUP BY d.dept_name ORDER BY d.dept_name"),
    ("strings", "SELECT s FROM a INTERSECT SELECT s FROM b"),
    ("strings", "SELECT s, n FROM a EXCEPT SELECT s, n FROM b"),
    ("strings", "SELECT s FROM a UNION SELECT s FROM b"),
    ("strings", "SELECT s FROM (SELECT s FROM a UNION ALL SELECT s FROM b) t "
                "ORDER BY s"),
    ("strings", "SELECT s, COUNT(*) FROM (SELECT s FROM a UNION ALL "
                "SELECT s FROM b) t GROUP BY s ORDER BY s"),
    ("strings", "SELECT DISTINCT s FROM a ORDER BY s"),
    ("strings", "SELECT n FROM a INTERSECT SELECT n FROM b"),
    ("strings", "SELECT n FROM (SELECT n FROM a UNION SELECT n FROM b) t "
                "ORDER BY n"),
    # reference behaviours of the parser, shared by both packages
    ("csv", "SELECT location FROM departments UNION ALL SELECT name FROM "
            "employees WHERE id < 3 UNION ALL SELECT NULL"),
    ("strings", "SELECT s FROM a UNION SELECT s FROM b UNION ALL "
                "SELECT s FROM a"),
]

# the JAX package raises these; the port must raise the same class
RAISING = [
    ("none", "SELECT * FROM GENERATE_SERIES(1, 5, 0)"),
    ("kv", "SELECT * FROM x, GENERATE_SERIES(1, a)"),
    ("none", "SELECT * FROM GENERATE_SERIES(DATE '2024-01-01', "
             "DATE '2024-01-02', INTERVAL '1 hour')"),
    ("none", "SELECT * FROM GENERATE_SERIES(DATE '2024-01-01', "
             "DATE '2024-01-05')"),
    # an ORDER BY after EXCEPT binds to the right-hand SELECT
    ("csv", "SELECT name FROM employees EXCEPT SELECT dept_name FROM "
            "departments ORDER BY name"),
]

def _run(s, sql):
    try:
        return s.sql(sql).to_pylist()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for fixture in {f for f, _ in CASES + RAISING}:
        js = JSession()
        _register(js, fixture, True)
        out.update({(fixture, sql): _run(js, sql)
                    for f, sql in CASES + RAISING if f == fixture})
    return out


MODES = ["compiled", "QE_COMPILED=0", "graphs"]


def _no_merge_in_a_body(*args):
    raise AssertionError("a program body merged two dictionaries")


def _session(fixture, mode, monkeypatch):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
        # as on CUDA, nothing may build a host table inside a program
        monkeypatch.setattr(pipeline, "unify_dicts", _no_merge_in_a_body)
    _register(s, fixture, False)
    return s


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", CASES,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(CASES)])
def test_case_matches_jax(jax_results, fixture, sql, mode, monkeypatch):
    want = jax_results[(fixture, sql)]
    assert not isinstance(want, str), want
    s = _session(fixture, mode, monkeypatch)
    oracle.compare(s.sql(sql).to_pylist(), want)
    pipe = s.executor.pipeline
    if mode == "QE_COMPILED=0":
        assert pipe.stats["compiles"] == 0, pipe.stats
        return
    assert pipe.stats["fallbacks"] == 0, pipe.stats
    assert "Distinct" not in pipe.leaf_kinds, pipe.leaf_kinds
    if "SetOp" in pipe.leaf_kinds:  # only a string set operation on CUDA
        assert mode == "graphs" and fixture in ("strings", "csv"), \
            pipe.leaf_kinds


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", RAISING,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(RAISING)])
def test_case_raises_as_in_jax(jax_results, fixture, sql, mode, monkeypatch):
    want = jax_results[(fixture, sql)]
    assert isinstance(want, str) and want != "NotImplementedError", want
    assert _run(_session(fixture, mode, monkeypatch), sql) == want


def test_integer_set_operations_trace_under_graphs(monkeypatch):
    """INTERSECT, EXCEPT and DISTINCT over integers run inside one program
    as on CUDA; a UNION of the same two tables' strings is a SetOp leaf,
    and a warm run of it finds its program again (the merged dictionary
    is the same object)."""
    s = _session("strings", "graphs", monkeypatch)
    pipe = s.executor.pipeline
    for q in ("SELECT n FROM a INTERSECT SELECT n FROM b",
              "SELECT n FROM a EXCEPT SELECT n FROM b",
              "SELECT DISTINCT n FROM a"):
        s.sql(q)
    assert not pipe.leaf_kinds, pipe.leaf_kinds
    q = "SELECT s FROM a UNION SELECT s FROM b"
    first = s.sql(q).to_pylist()
    compiles = pipe.stats["compiles"]
    assert s.sql(q).to_pylist() == first
    assert pipe.stats["compiles"] == compiles
    assert pipe.leaf_kinds["SetOp"] == 2
