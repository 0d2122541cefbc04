"""The statistics aggregates, ROLLUP / CUBE / GROUPING SETS and GROUPING()
in the port against the JAX package, through both Sessions.

The plan layer lowers VAR_*, STDDEV_*, COVAR_*, CORR and REGR_* into SUMs
and COUNTs plus a formula with NULLIF, SQRT and CASE
(plan/lowering.py), and GROUPING() into `__grouping / 2^k % 2`
(plan/planner.py): both need the evaluator's NULLIF, SQRT and %. The SQL
cases of tests/test_statistics_aggs.py (their mesh, chunked and
ordered-set cases stay out) and tests/test_grouping_sets.py, and a CUBE
with GROUPING() over string keys, run on the same tables through the JAX
Session and the port's `Session(device="cpu")`: with the compiled pipeline
on, with it off (QE_COMPILED=0), and with the pipeline admitting nodes as
on CUDA (`_graphs = True`, `_capture` stubbed), where the UNION ALL of a
grouping set's aggregates must run inside the program (its string keys
share one dictionary, or are NULL) and nothing may merge dictionaries
there. Rows must be equal and in the same order: integers and strings
exactly, floats to rtol 1e-9. Where the JAX package raises, the port
raises the same error class.
"""

import os

import numpy as np
import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine import pipeline
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import oracle

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")

# tests/test_statistics_aggs.py's tables, drawn in its order
RNG = np.random.default_rng(11)
N = 3000
K = RNG.integers(0, 25, N)
V = RNG.normal(50, 12, N).round(5)
VNULL = RNG.random(N) < 0.07
IV = RNG.integers(-40, 900, N)
X2 = RNG.normal(10, 4, N).round(5)
X2NULL = RNG.random(N) < 0.06


def _register(s, fixture):
    if fixture == "stats":
        s.register_table("t", {
            "k": K.tolist(),
            "v": [None if b else float(x) for x, b in zip(V, VNULL)],
            "iv": IV.tolist(),
        })
        s.register_table("t2", {
            "k": K.tolist(),
            "y": [None if b else float(v) for v, b in zip(V, VNULL)],
            "x": [None if b else float(v) for v, b in zip(X2, X2NULL)],
        })
        s.register_table("e", {"k": [1, 2, 2, 3], "v": [5.0, 1.0, 3.0, None]})
        s.register_table("pe", {"g": [1, 1, 2, 3, 3],
                                "y": [None, 1.0, 5.0, 2.0, 4.0],
                                "x": [1.0, None, 7.0, 3.0, 3.0]})
        s.register_table("cy", {"y": [3.0, 3.0, 3.0], "x": [1.0, 2.0, 5.0]})
    elif fixture == "csv":
        s.register_csv("employees", os.path.join(DATA, "employees.csv"))
        s.register_table("t", {"s": ["a", "b", "a"], "v": [1, 2, 3]})
        s.register_table("u", {
            "s": ["x", "y", None, "x", "z", "y", "x", None],
            "m": ["p", "q", "p", None, "q", "q", "p", "p"],
            "k": [1, 2, 1, 3, 2, 2, 1, None],
            "v": [1.5, 2.0, 3.25, -1.0, 0.5, 4.0, 2.5, 7.0]})
    else:
        raise ValueError(fixture)


CASES = [
    # tests/test_statistics_aggs.py
    ("stats", "SELECT k, VAR_SAMP(v), VAR_POP(v), STDDEV_SAMP(v), "
              "STDDEV_POP(v) FROM t GROUP BY k ORDER BY k"),
    ("stats", "SELECT VARIANCE(v), STDDEV(v), AVG(v), COUNT(v) FROM t"),
    ("stats", "SELECT STDDEV_POP(iv), VAR_SAMP(iv) FROM t"),
    ("stats", "SELECT k, VAR_SAMP(v), VAR_POP(v), STDDEV_SAMP(v) FROM e "
              "GROUP BY k ORDER BY k"),
    ("stats", "SELECT VARIANCE(v) FROM e WHERE v > 99"),
    ("stats", "SELECT k, STDDEV(v) * 2 AS d2 FROM t GROUP BY k "
              "HAVING STDDEV(v) > 11 ORDER BY d2 DESC LIMIT 5"),
    ("stats", "SELECT k % 3 AS g, VAR_POP(v) FROM t GROUP BY ROLLUP (k % 3) "
              "ORDER BY g"),
    ("stats", "SELECT k, VAR_SAMP(v) AS vs FROM t GROUP BY k ORDER BY k"),
    ("stats", "SELECT k, COVAR_POP(y, x), COVAR_SAMP(y, x), CORR(y, x), "
              "REGR_SLOPE(y, x), REGR_INTERCEPT(y, x), REGR_R2(y, x), "
              "REGR_AVGX(y, x), REGR_AVGY(y, x), REGR_COUNT(y, x), "
              "REGR_SXX(y, x), REGR_SYY(y, x), REGR_SXY(y, x) "
              "FROM t2 GROUP BY k ORDER BY k"),
    ("stats", "SELECT g, COVAR_POP(y, x), COVAR_SAMP(y, x), CORR(y, x), "
              "REGR_SLOPE(y, x), REGR_R2(y, x), REGR_COUNT(y, x) "
              "FROM pe GROUP BY g ORDER BY g"),
    ("stats", "SELECT REGR_R2(y, x), REGR_SLOPE(y, x), CORR(y, x) FROM cy"),
    ("stats", "SELECT REGR_COUNT(y, x), CORR(y, x) FROM cy WHERE x > 99"),
    ("stats", "SELECT k, CORR(y + 1, x * 2) AS c2 FROM t2 GROUP BY k "
              "HAVING REGR_COUNT(y, x) > 50 ORDER BY k"),
    ("stats", "SELECT k, COVAR_SAMP(y, x) AS cs FROM t2 GROUP BY k "
              "ORDER BY k"),
    ("stats", "SELECT k % 5 AS b, STDDEV_SAMP(v), CORR(v, iv), "
              "REGR_INTERCEPT(v, iv) FROM t WHERE iv % 3 <> 0 "
              "GROUP BY k % 5 ORDER BY b"),
    # tests/test_grouping_sets.py
    ("csv", "SELECT dept_id, COUNT(*), SUM(salary) FROM employees "
            "GROUP BY ROLLUP(dept_id)"),
    ("csv", "SELECT dept_id, age, COUNT(*) FROM employees "
            "GROUP BY ROLLUP(dept_id, age)"),
    ("csv", "SELECT dept_id, age, COUNT(*) FROM employees "
            "GROUP BY CUBE(dept_id, age)"),
    ("csv", "SELECT dept_id, age, COUNT(*) FROM employees "
            "GROUP BY GROUPING SETS ((dept_id), (age), ())"),
    ("csv", "SELECT s, SUM(v) FROM t GROUP BY ROLLUP(s)"),
    ("csv", "SELECT dept_id, COUNT(*) AS c FROM employees "
            "GROUP BY ROLLUP(dept_id) ORDER BY c, dept_id"),
    ("csv", "SELECT dept_id, GROUPING(dept_id) AS g, COUNT(*) FROM employees "
            "GROUP BY ROLLUP(dept_id)"),
    ("csv", "SELECT GROUPING(dept_id, age) AS g, COUNT(*) FROM employees "
            "GROUP BY ROLLUP(dept_id, age)"),
    # CUBE and ROLLUP over string keys with GROUPING()
    ("csv", "SELECT s, m, GROUPING(s, m) AS g, COUNT(*) AS c, SUM(v) AS sv "
            "FROM u GROUP BY CUBE (s, m) ORDER BY g, s, m"),
    ("csv", "SELECT s, k, GROUPING(s) AS gs, GROUPING(k) AS gk, "
            "GROUPING(k, s) AS g2, AVG(v) FROM u GROUP BY ROLLUP (s, k) "
            "ORDER BY g2, s, k"),
    ("csv", "SELECT name, dept_id, GROUPING(name, dept_id) AS g, "
            "MAX(salary) FROM employees GROUP BY GROUPING SETS ((name), "
            "(dept_id), ()) ORDER BY g, name, dept_id"),
]

# the JAX package raises these; the port must raise the same class
RAISING = [
    ("stats", "SELECT VAR_SAMP(DISTINCT v) FROM t"),
    ("stats", "SELECT STDDEV(CAST(k AS VARCHAR)) FROM t"),
    ("stats", "SELECT STDDEV(v) OVER (PARTITION BY k) FROM t"),
    ("stats", "SELECT CORR(CAST(k AS VARCHAR), x) FROM t2"),
    ("stats", "SELECT CORR(y) FROM t2"),
    ("stats", "SELECT COVAR_POP(DISTINCT y, x) FROM t2"),
    ("csv", "SELECT dept_id, GROUPING(dept_id) FROM employees "
            "GROUP BY dept_id"),
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


def _no_merge_in_a_body(*args):
    raise AssertionError("a program body merged two dictionaries")


def _session(fixture, mode, monkeypatch):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
        monkeypatch.setattr(pipeline, "unify_dicts", _no_merge_in_a_body)
    _register(s, fixture)
    return s


def _ids(cases):
    return [f"{f}-{i}" for i, (f, _) in enumerate(cases)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", CASES, ids=_ids(CASES))
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
    # a grouping set's UNION ALL runs inside the program
    assert "SetOp" not in pipe.leaf_kinds, pipe.leaf_kinds


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", RAISING, ids=_ids(RAISING))
def test_case_raises_as_in_jax(jax_results, fixture, sql, mode,
                               monkeypatch):
    want = jax_results[(fixture, sql)]
    assert isinstance(want, str) and want != "NotImplementedError", want
    assert _run(_session(fixture, mode, monkeypatch), sql) == want


def test_variance_against_two_pass_numpy(jax_results):
    """The one-pass formula the plan lowers to, held against numpy's
    two-pass variance per group (test_statistics_aggs.py's check)."""
    rows = jax_results[("stats", CASES[0][1])]
    s = Session(device="cpu")
    _register(s, "stats")
    got = s.sql(CASES[0][1]).to_pylist()
    oracle.compare(got, rows)
    for g, vs, vp, ss, sp in got:
        vals = V[(K == g) & ~VNULL]
        for have, want in ((vs, vals.var(ddof=1)), (vp, vals.var()),
                           (ss, vals.std(ddof=1)), (sp, vals.std())):
            assert have == pytest.approx(want, rel=1e-9)


def test_cube_grouping_golden(jax_results):
    """GROUPING(s, m) is 0 for the (s, m) groups, 1 with m rolled up, 2
    with s rolled up and 3 for the total: 4 x NULL-aware groups in all."""
    sql = next(q for _, q in CASES if "CUBE (s, m)" in q)
    rows = jax_results[("csv", sql)]
    assert sorted({r[2] for r in rows}) == [0, 1, 2, 3]
    assert rows[-1][:4] == (None, None, 3, 8)
    s = Session(device="cpu")
    _register(s, "csv")
    oracle.compare(s.sql(sql).to_pylist(), rows)
