"""The port's Session against the JAX package's, end to end.

The bench query at 5000 fact rows and the slice's subset of the
employees/departments queries (tests/test_e2e_queries.py) go through both
Sessions on the same tables; rows must be identical and in the same order,
and EXPLAIN text identical. Also: an UPDATE and an INSERT (which raised
before the port had DML) give the JAX Session's statuses and following
rows, and importing the port and running a query leaves jax out of the
process.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.columnar.convert import from_numpy_batch
from query_engine_tpu_torch.engine.session import Session

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")

BENCH_QUERY = (
    "SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
    "FROM f JOIN d ON f.dept = d.dept_id "
    "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10"
)


def _bench_tables(n, seed=7):
    """The bench's distributions (bench.py:471-490) as JAX batches."""
    rng = np.random.default_rng(seed)
    f = JBatch.from_pydict({
        "age": rng.integers(18, 65, n),
        "salary": rng.integers(50_000, 150_000, n),
        "dept": rng.integers(0, 1024, n),
    })
    d = JBatch.from_pydict({
        "dept_id": np.arange(1024), "bonus": rng.integers(0, 1000, 1024),
    })
    return f, d


def _port(b):
    """The same table in the port, through the state-transfer function."""
    planes = [(np.asarray(c.data), np.asarray(c.validity),
               None if c.dictionary is None else c.dictionary.values)
              for c in b.columns]
    return from_numpy_batch(list(b.schema), planes, b.num_rows, "cpu")


@pytest.fixture(scope="module")
def bench_pair():
    f, d = _bench_tables(5000)
    js = JSession()
    js.register_table("f", f)
    js.register_table("d", d)
    ts = Session(device="cpu")
    ts.register_table("f", _port(f))
    ts.register_table("d", _port(d))
    return js, ts


def test_bench_query_matches_jax(bench_pair):
    js, ts = bench_pair
    want = js.sql(BENCH_QUERY).to_pylist()
    got = ts.sql(BENCH_QUERY)
    assert got.to_pylist() == want
    assert len(want) == 10
    assert ts.explain(BENCH_QUERY) == js.explain(BENCH_QUERY)
    assert all(c.data.device.type == "cpu" for c in got.columns)


def test_bench_query_with_nulls_and_ties_matches_jax():
    """NULL group keys and duplicate sums: ORDER BY s DESC ties keep group
    order in both packages."""
    js, ts = JSession(), Session(device="cpu")
    data = {
        "dept": [3, 1, None, 2, 1, None, 3, 2, 5],
        "salary": [10, 20, 30, 20, 10, 0, 20, 10, None],
        "age": [30, 40, 50, 60, 70, 80, 90, 20, 99],
    }
    dim = {"dept_id": [1, 2, 3, 4], "bonus": [0, 0, 0, 7]}
    for s in (js, ts):
        s.register_table("f", data)
        s.register_table("d", dim)
    q = ("SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
         "FROM f JOIN d ON f.dept = d.dept_id "
         "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10")
    assert ts.sql(q).to_pylist() == js.sql(q).to_pylist()
    q2 = ("SELECT dept, COUNT(*), SUM(salary) FROM f GROUP BY dept "
          "ORDER BY 3 DESC NULLS FIRST")
    assert ts.sql(q2).to_pylist() == js.sql(q2).to_pylist()


@pytest.fixture(scope="module")
def csv_pair():
    js, ts = JSession(), Session(device="cpu")
    for s in (js, ts):
        s.register_csv("employees", os.path.join(DATA, "employees.csv"))
        s.register_csv("departments", os.path.join(DATA, "departments.csv"))
    return js, ts


E2E = [
    "SELECT name, age FROM employees WHERE age > 25",
    "SELECT name FROM employees WHERE age > 25 AND salary < 90000 OR id = 1",
    "SELECT name, salary * 2, salary / 1000 FROM employees WHERE id = 1",
    "SELECT name, salary - 1000, -age, salary / 7.0 FROM employees",
    "SELECT name FROM employees WHERE dept_id = 101",
    "SELECT name FROM employees WHERE dept_id IS NULL",
    "SELECT name FROM employees WHERE dept_id IS NOT NULL ORDER BY id",
    "SELECT name FROM employees WHERE NOT (age > 30) ORDER BY name DESC",
    "SELECT COUNT(*), COUNT(dept_id), SUM(salary), AVG(salary), "
    "MIN(age), MAX(age) FROM employees",
    "SELECT dept_id, COUNT(*), SUM(salary), AVG(salary) FROM employees "
    "GROUP BY dept_id ORDER BY dept_id",
    "SELECT dept_id, MIN(salary), MAX(name) FROM employees "
    "GROUP BY dept_id ORDER BY dept_id NULLS FIRST",
    "SELECT dept_id, COUNT(*) AS c FROM employees GROUP BY dept_id "
    "HAVING COUNT(*) > 1 ORDER BY dept_id",
    "SELECT COUNT(*), SUM(salary) FROM employees WHERE age > 100",
    "SELECT dept_id, COUNT(*) FROM employees WHERE age > 100 "
    "GROUP BY dept_id",
    "SELECT name, salary FROM employees ORDER BY salary DESC LIMIT 3",
    "SELECT name, dept_id, age FROM employees "
    "ORDER BY dept_id DESC NULLS LAST, age LIMIT 3 OFFSET 1",
    "SELECT e.name, d.dept_name FROM employees e "
    "JOIN departments d ON e.dept_id = d.dept_id ORDER BY e.name",
    "SELECT d.dept_name, COUNT(*), SUM(e.salary) FROM employees e "
    "JOIN departments d ON e.dept_id = d.dept_id "
    "GROUP BY d.dept_name ORDER BY d.dept_name",
    "SELECT name FROM employees WHERE name > 'C' ORDER BY name",
    "SELECT name, CAST(salary AS DOUBLE) / 4, CAST(age AS INT) "
    "FROM employees WHERE dept_id <> 102",
]


@pytest.mark.parametrize("query", E2E)
def test_e2e_queries_match_jax(csv_pair, query):
    js, ts = csv_pair
    want = js.sql(query)
    got = ts.sql(query)
    assert got.to_pylist() == want.to_pylist()
    assert got.schema.names() == want.schema.names()
    assert ts.explain(query) == js.explain(query)


def test_e2e_golden_rows(csv_pair):
    """Frank's NULL dept groups last under ORDER BY ASC (the expected rows
    of tests/test_e2e_queries.py)."""
    _, ts = csv_pair
    out = ts.sql(
        "SELECT dept_id, COUNT(*), SUM(salary), AVG(salary) FROM employees "
        "GROUP BY dept_id ORDER BY dept_id"
    ).to_pylist()
    assert out == [(101, 2, 170000, 85000.0), (102, 2, 175000, 87500.0),
                   (103, 1, 80000, 80000.0), (None, 1, 78000, 78000.0)]


def test_explain_analyze_runs(csv_pair):
    _, ts = csv_pair
    lines = [r[0] for r in ts.sql(
        "EXPLAIN ANALYZE SELECT name FROM employees WHERE age > 25"
    ).to_pylist()]
    assert lines[0].startswith("Projection") or "Filter" in "\n".join(lines)
    assert "rows: 5" in lines


def _same_floats(rows):
    """Rows with each float as (is NaN, sign, value): any NaN compares equal
    to any NaN (a NaN's sign bit is not part of a result), and -0.0 apart
    from 0.0."""
    return [tuple(((True, 0.0, 0.0) if math.isnan(x)
                   else (False, math.copysign(1.0, x), x))
                  if isinstance(x, float) else x for x in row)
            for row in rows]


@pytest.mark.parametrize("expr", ["(b*10)*0.0", "-((b*10)*0.0)"])
@pytest.mark.parametrize("order", ["", " DESC"])
def test_nan_sort_key_sorts_last_in_both(expr, order):
    """NaN from overflow (b*10 = +-inf at b = +-1e308, times 0.0) sorts last
    in both packages, whatever its sign and the direction."""
    data = {"a": [1, 2, 3, 4, 5, 6],
            "b": [1e308, -1e308, 2.0, -3.5, 0.0, 1e308]}
    js, ts = JSession(), Session(device="cpu")
    for s in (js, ts):
        s.register_table("t", data)
    q = f"SELECT a, {expr} AS x FROM t ORDER BY x{order}"
    want = js.sql(q).to_pylist()
    assert sum(math.isnan(x) for _, x in want) == 3
    assert all(math.isnan(x) for _, x in want[3:])
    assert _same_floats(ts.sql(q).to_pylist()) == _same_floats(want)


@pytest.mark.parametrize("query", [
    "SELECT LENGTH(name) FROM employees",
    "SELECT UPPER(name) FROM employees",
])
def test_string_functions_match_jax(csv_pair, query):
    """LENGTH and UPPER, which raised before the port had the string
    functions, give the JAX Session's rows."""
    js, ts = csv_pair
    want = js.sql(query).to_pylist()
    assert len(want) == 6
    assert ts.sql(query).to_pylist() == want


@pytest.mark.parametrize("query", [
    "UPDATE employees SET age = 41 WHERE id = 1",
    "INSERT INTO employees VALUES (7, 'Gus', 40, 1, 101)",
])
def test_outside_the_slice_raises(query):
    """The two statements that raised NotImplementedError before the port
    had DML now give the JAX Session's status, and the table then reads as
    the JAX Session's does (a fresh pair of Sessions: the module's shared
    tables stay as they are)."""
    js, ts = JSession(), Session(device="cpu")
    for s in (js, ts):
        s.register_csv("employees", os.path.join(DATA, "employees.csv"))
    want = js.sql(query).to_pylist()
    assert want in ([("UPDATE 1",)], [("INSERT 0 1",)])
    assert ts.sql(query).to_pylist() == want
    q = "SELECT * FROM employees ORDER BY id"
    assert ts.sql(q).to_pylist() == js.sql(q).to_pylist()


@pytest.mark.parametrize("query", [
    "SELECT name FROM employees UNION SELECT dept_name FROM departments",
    "SELECT name, ROW_NUMBER() OVER (ORDER BY age) FROM employees",
    "SELECT DISTINCT dept_id FROM employees",
])
def test_set_op_window_and_distinct_match_jax(csv_pair, query):
    """A UNION, a window function and SELECT DISTINCT, which raised before
    the port had them, give the JAX Session's rows."""
    js, ts = csv_pair
    want = js.sql(query).to_pylist()
    assert want
    assert ts.sql(query).to_pylist() == want


def test_left_join_matches_jax(csv_pair):
    """A LEFT join keeps Frank, whose dept_id is NULL, with a NULL
    department."""
    js, ts = csv_pair
    q = ("SELECT e.name, d.dept_name FROM employees e LEFT JOIN departments d "
         "ON e.dept_id = d.dept_id ORDER BY e.name")
    want = js.sql(q).to_pylist()
    assert ts.sql(q).to_pylist() == want
    assert ("Frank", None) in want


def test_register_parquet(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": [1, 2, 1, None], "v": [1.5, 2.0, 3.0, 4.0]}),
                   path)
    js, ts = JSession(), Session(device="cpu")
    for s in (js, ts):
        s.register_parquet("t", path)
    q = "SELECT k, SUM(v), COUNT(*) FROM t GROUP BY k ORDER BY k"
    assert ts.sql(q).to_pylist() == js.sql(q).to_pylist()


def test_register_source():
    from query_engine_tpu.storage.csv import CsvDataSource as JCsv
    from query_engine_tpu_torch.storage.csv import CsvDataSource

    path = os.path.join(DATA, "departments.csv")
    js, ts = JSession(), Session(device="cpu")
    js.register_source("dep", JCsv(path))
    ts.register_source("dep", CsvDataSource(path))
    q = "SELECT dept_name, location FROM dep WHERE dept_id >= 102"
    assert ts.sql(q).to_pylist() == js.sql(q).to_pylist()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import query_engine_tpu_torch\n"
        "from query_engine_tpu_torch.engine.session import Session\n"
        "s = Session(device='cpu')\n"
        f"s.register_csv('employees', {os.path.join(DATA, 'employees.csv')!r})\n"
        "rows = s.sql('SELECT COUNT(*) FROM employees WHERE age > 25')"
        ".to_pylist()\n"
        "assert rows == [(5,)], rows\n"
        "from query_engine_tpu_torch.tpch import data, oracle, queries\n"
        "t = data.generate(1 << 10)\n"
        "data.register(s, t)\n"
        "oracle.compare(s.sql(queries.QUERIES['Q13']).to_pylist(),\n"
        "               oracle.run('Q13', t))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'query_engine_tpu' or "
        "m.startswith('query_engine_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_tpch_subpackage_needs_no_pandas_or_pyarrow():
    """The TPC-H tables, queries and oracle run with pandas and pyarrow
    blocked from import."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = sys.modules['pyarrow'] = None\n"
        "from query_engine_tpu_torch.engine.session import Session\n"
        "from query_engine_tpu_torch.tpch import data, oracle, queries\n"
        "t = data.generate(1 << 10)\n"
        "s = Session(device='cpu')\n"
        "data.register(s, t)\n"
        "for q in ('Q1', 'Q9'):\n"
        "    oracle.compare(s.sql(queries.QUERIES[q]).to_pylist(),\n"
        "                   oracle.run(q, t))\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_session_defaults_to_the_card(monkeypatch):
    """Session() runs on CUDA; without CUDA it raises at construction and
    Session(device="cpu") runs."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session(device="cuda")
    s = Session(device="cpu")
    assert s.device.type == "cpu"
    s.register_table("t", {"x": [1, 2, 3]})
    assert s.sql("SELECT SUM(x) FROM t").to_pylist() == [(6,)]


def test_executor_and_evaluator_need_a_device():
    """The device is explicit everywhere: QueryExecutor and Evaluator take
    no default (a Session passes its own, the card unless asked for the
    CPU)."""
    from query_engine_tpu_torch.engine.executor import QueryExecutor
    from query_engine_tpu_torch.engine.expr_eval import Evaluator

    with pytest.raises(TypeError):
        QueryExecutor()
    with pytest.raises(TypeError):
        Evaluator()
    assert QueryExecutor("cpu").device == Evaluator("cpu").device
