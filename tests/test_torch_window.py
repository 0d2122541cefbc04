"""Window functions in the port against the JAX package, through both
Sessions.

Every SQL case of tests/test_window_aggregates.py and
tests/test_window_rank_dist.py (their mesh cases stay out) and the window
cases of tests/test_e2e_queries.py and tests/test_edge_cases.py run on the
same tables through the JAX Session and the port's `Session(device="cpu")`:
with the compiled pipeline on, with it off (QE_COMPILED=0), and with the
pipeline admitting nodes as on CUDA
(`_graphs = True`, `_capture` stubbed). Rows must be equal and in the same
order: integers and strings exactly, floats to rtol 1e-9. Where the JAX
package raises, the port raises the same error class.

Also: window specs whose ORDER BY extends another's share its sort where
the function cannot see the order within peers. Every window function over
strings, +-inf and int64 is in tests/test_torch_window_functions.py.
"""

import os

import numpy as np
import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import oracle

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def _agg_table():
    """test_window_aggregates.py's table: 300 rows, 7 groups, 30 NULLs."""
    rng = np.random.default_rng(5)
    n = 300
    g = rng.integers(0, 7, n)
    v = rng.integers(-100, 100, n).astype(float)
    v[rng.choice(n, 30, replace=False)] = np.nan
    return {"id": list(range(n)), "g": [int(x) for x in g],
            "v": [None if np.isnan(x) else int(x) for x in v]}


def _rank_table():
    """test_window_rank_dist.py's table: 1200 rows, heavy ties."""
    rng = np.random.default_rng(31)
    n = 1200
    k = rng.integers(0, 9, n)
    v = rng.integers(0, 25, n)
    return {"id": list(range(n)), "k": [int(x) for x in k],
            "v": [int(x) for x in v]}


def _range_table():
    """test_window_rank_dist.py's RANGE offset table: float keys, NULLs."""
    rng = np.random.default_rng(17)
    n = 1500
    k = rng.integers(0, 4, n)
    vn = [None if rng.random() < 0.06 else float(x)
          for x in rng.integers(0, 80, n)]
    return {"id": list(range(n)), "k": [int(x) for x in k], "v": vn}


FIXTURES = {
    "agg": {"t": _agg_table},
    "rank": {"t": _rank_table},
    "range": {"e": _range_table},
    "small": {
        "e": lambda: {"k": [1, 2, 3], "v": [9, 5, 7]},
        "n": lambda: {"k": [1] * 5 + [2] * 2,
                      "v": [10, 20, 20, 30, None, 7, 8]},
        "nul": lambda: {"k": [None, None, None], "v": [None, 1, None]},
    },
}


def _register(s, fixture):
    if fixture == "csv":
        for name in ("employees", "departments"):
            s.register_csv(name, os.path.join(DATA, f"{name}.csv"))
        return
    for name, make in FIXTURES[fixture].items():
        s.register_table(name, make())


CASES = [
    # tests/test_window_aggregates.py
    ("agg", "SELECT id, SUM(v) OVER (PARTITION BY g ORDER BY id) FROM t "
            "ORDER BY id"),
    ("agg", "SELECT id, AVG(v) OVER (ORDER BY id ROWS BETWEEN 2 PRECEDING "
            "AND CURRENT ROW) FROM t ORDER BY id"),
    ("agg", "SELECT id, SUM(v) OVER (PARTITION BY g), COUNT(v) OVER "
            "(PARTITION BY g), COUNT(*) OVER (PARTITION BY g) FROM t "
            "ORDER BY id"),
    ("agg", "SELECT id, MIN(v) OVER (PARTITION BY g ORDER BY id), "
            "MAX(v) OVER (PARTITION BY g ORDER BY id) FROM t ORDER BY id"),
    ("agg", "SELECT g, SUM(v) OVER (ORDER BY g) AS r FROM t ORDER BY g, id"),
    ("agg", "SELECT id, SUM(v) OVER (ORDER BY id ROWS BETWEEN CURRENT ROW "
            "AND 1 FOLLOWING) FROM t ORDER BY id"),
    ("agg", "SELECT id, MIN(v) OVER (PARTITION BY g ORDER BY id ROWS "
            "BETWEEN 3 PRECEDING AND CURRENT ROW) FROM t ORDER BY id"),
    ("agg", "SELECT id, MAX(v) OVER (ORDER BY id ROWS BETWEEN 2 PRECEDING "
            "AND 2 FOLLOWING) FROM t ORDER BY id"),
    ("agg", "SELECT id, MIN(v) OVER (PARTITION BY g ORDER BY id ROWS "
            "BETWEEN 1 PRECEDING AND UNBOUNDED FOLLOWING) FROM t ORDER BY id"),
    ("agg", "SELECT id, RANK() OVER (PARTITION BY g ORDER BY v) AS r, "
            "SUM(v) OVER (PARTITION BY g ORDER BY v) AS run, "
            "ROW_NUMBER() OVER (PARTITION BY g ORDER BY v, id) AS rn "
            "FROM t ORDER BY id LIMIT 50"),
    # tests/test_window_rank_dist.py
    ("rank", "SELECT id, PERCENT_RANK() OVER (PARTITION BY k ORDER BY v) "
             "AS pr, CUME_DIST() OVER (PARTITION BY k ORDER BY v) AS cd "
             "FROM t ORDER BY id"),
    ("small", "SELECT k, PERCENT_RANK() OVER (PARTITION BY k ORDER BY v) "
              "AS pr, CUME_DIST() OVER (PARTITION BY k ORDER BY v) AS cd "
              "FROM e ORDER BY k"),
    ("small", "SELECT v, PERCENT_RANK() OVER (ORDER BY v) AS pr, "
              "CUME_DIST() OVER (ORDER BY v) AS cd FROM e ORDER BY v"),
    ("small", "SELECT k, v, NTH_VALUE(v, 3) OVER (PARTITION BY k ORDER BY v) "
              "AS d, NTH_VALUE(v, 3) OVER (PARTITION BY k ORDER BY v ROWS "
              "BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS u "
              "FROM n ORDER BY k, v"),
    ("rank", "SELECT RANK() OVER (PARTITION BY k ORDER BY v), "
             "PERCENT_RANK() OVER (PARTITION BY k ORDER BY v), "
             "CUME_DIST() OVER (PARTITION BY k ORDER BY v) FROM t"),
    ("rank", "SELECT id, PERCENT_RANK() OVER (PARTITION BY k ORDER BY v) "
             "AS pr, CUME_DIST() OVER (PARTITION BY k ORDER BY v) AS cd, "
             "NTH_VALUE(v, 2) OVER (PARTITION BY k ORDER BY v) AS nv "
             "FROM t ORDER BY id"),
    ("rank", "SELECT id, CUME_DIST() OVER (ORDER BY v) AS cd, "
             "PERCENT_RANK() OVER (ORDER BY v) AS pr FROM t ORDER BY id"),
    ("rank", "SELECT id, NTH_VALUE(v, 3) OVER (ORDER BY v ROWS BETWEEN "
             "UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS nv "
             "FROM t ORDER BY id"),
    ("range", "SELECT id, SUM(v) OVER (PARTITION BY k ORDER BY v RANGE "
              "BETWEEN 5 PRECEDING AND 2 FOLLOWING) AS sm, COUNT(v) OVER "
              "(PARTITION BY k ORDER BY v DESC RANGE BETWEEN 5 PRECEDING "
              "AND 2 FOLLOWING) AS cd, AVG(v) OVER (PARTITION BY k ORDER BY "
              "v RANGE BETWEEN UNBOUNDED PRECEDING AND 3 FOLLOWING) AS au, "
              "MIN(v) OVER (PARTITION BY k ORDER BY v RANGE BETWEEN 4 "
              "PRECEDING AND UNBOUNDED FOLLOWING) AS mu FROM e ORDER BY id"),
    ("range", "SELECT id, SUM(v) OVER (PARTITION BY k ORDER BY v RANGE "
              "BETWEEN 4 PRECEDING AND 4 FOLLOWING) AS r FROM e ORDER BY id"),
    ("range", "SELECT id, SUM(v) OVER (ORDER BY v RANGE BETWEEN 4 PRECEDING "
              "AND 4 FOLLOWING) AS r FROM e ORDER BY id"),
    # test_window_aggregates.py::test_compiled_matches_eager
    ("agg", "SELECT id, SUM(v) OVER (PARTITION BY g ORDER BY id) AS r, "
            "MAX(v) OVER (PARTITION BY g) AS m FROM t WHERE id % 2 = 0 "
            "ORDER BY id"),
    # tests/test_e2e_queries.py and tests/test_edge_cases.py
    ("csv", "SELECT name, dept_id, ROW_NUMBER() OVER (PARTITION BY dept_id "
            "ORDER BY salary DESC) AS rn, RANK() OVER (ORDER BY salary DESC)"
            " AS rk FROM employees ORDER BY id"),
    ("csv", "SELECT name, LAG(salary, 1) OVER (ORDER BY salary) AS prev, "
            "LEAD(salary, 1) OVER (ORDER BY salary) AS nxt "
            "FROM employees ORDER BY salary"),
    ("csv", "SELECT name, ROW_NUMBER() OVER (ORDER BY age) FROM employees"),
    ("small", "SELECT k, ROW_NUMBER() OVER (ORDER BY v) FROM nul"),
    ("small", "SELECT AVG(v) OVER (ORDER BY k) FROM nul"),
]

# the JAX package raises these; the port must raise the same class
RAISING = [
    ("small", "SELECT NTH_VALUE(v, 0) OVER (ORDER BY v) FROM e"),
    ("range", "SELECT MAX(v) OVER (ORDER BY v, id RANGE BETWEEN 1 PRECEDING "
              "AND 1 FOLLOWING) FROM e"),
    ("range", "SELECT MIN(v) OVER (ORDER BY v RANGE BETWEEN 1 PRECEDING "
              "AND 1 FOLLOWING) FROM e"),
    ("agg", "SELECT SUM(v) OVER (ORDER BY id ROWS BETWEEN 1 FOLLOWING AND "
            "2 FOLLOWING) FROM t"),
    ("agg", "SELECT SUM(v) OVER (ORDER BY id ROWS BETWEEN 2 PRECEDING AND "
            "1 PRECEDING) FROM t"),
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
        _register(js, fixture)
        out.update({(fixture, sql): _run(js, sql)
                    for f, sql in CASES + RAISING if f == fixture})
    return out


MODES = ["compiled", "QE_COMPILED=0", "graphs"]


def _session(fixture, mode):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
    _register(s, fixture)
    return s


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", CASES,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(CASES)])
def test_window_case_matches_jax(jax_results, fixture, sql, mode):
    want = jax_results[(fixture, sql)]
    assert not isinstance(want, str), want
    s = _session(fixture, mode)
    oracle.compare(s.sql(sql).to_pylist(), want)
    stats = s.executor.pipeline.stats
    if mode == "QE_COMPILED=0":
        assert stats["compiles"] == 0, stats
    else:  # every window ran inside a program
        assert stats["fallbacks"] == 0, stats
        assert "Window" not in s.executor.pipeline.leaf_kinds


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", RAISING,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(RAISING)])
def test_window_case_raises_as_in_jax(jax_results, fixture, sql, mode):
    want = jax_results[(fixture, sql)]
    assert want == "ExecutionError", want
    assert _run(_session(fixture, mode), sql) == want


@pytest.mark.parametrize("sql,specs,sorts", [
    # RANK and SUM (order-independent) share ROW_NUMBER's longer spec
    ("SELECT id, RANK() OVER (PARTITION BY g ORDER BY v) AS r, "
     "SUM(v) OVER (PARTITION BY g ORDER BY v) AS run, "
     "ROW_NUMBER() OVER (PARTITION BY g ORDER BY v, id) AS rn "
     "FROM t ORDER BY id LIMIT 50", 2, 1),
    ("SELECT RANK() OVER (PARTITION BY g ORDER BY v), "
     "PERCENT_RANK() OVER (PARTITION BY g ORDER BY v), "
     "CUME_DIST() OVER (PARTITION BY g ORDER BY v) FROM t", 1, 1),
    # ROW_NUMBER sees the order within peers: its own sort
    ("SELECT ROW_NUMBER() OVER (PARTITION BY g ORDER BY v), "
     "ROW_NUMBER() OVER (PARTITION BY g ORDER BY v, id) FROM t", 2, 2),
])
def test_prefix_specs_share_a_sort(sql, specs, sorts):
    """Specs whose ORDER BY is a prefix of another's share its sort when
    the function cannot see the order within peers (the JAX pipeline's
    shared-sort planning); the rows equal the eager executor's."""
    s = _session("agg", "compiled")
    got = s.sql(sql).to_pylist()
    st = s.executor.pipeline.stats
    assert (st["window_specs"], st["window_sorts"]) == (specs, sorts), st
    assert got == _session("agg", "QE_COMPILED=0").sql(sql).to_pylist()
