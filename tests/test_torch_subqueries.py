"""Subquery expressions, COUNT(DISTINCT) and their torch ops in the port,
against the JAX package.

* every SQL case of tests/test_correlated_subqueries.py (on the
  employees/departments CSV fixtures) and of the subquery cases of
  tests/test_quantified_cmp.py (on their in-memory tables) gives the JAX
  Session's rows through the port's Session on the CPU, with the compiled
  pipeline on and off; a case that raises in the JAX package raises the
  same error class in the port;
* scalar, IN and EXISTS subqueries over NULLs and empty sets, and
  COUNT/SUM/AVG(DISTINCT), grouped and global, against JAX;
* `rank_member`, `distinct_first_flags` and `segment_aggregate` with a
  dedup plane against the JAX package's `ops/kernels.py`, on seeded numpy
  inputs with NULLs and pad rows.

Integers and strings must match exactly, floats to rtol 1e-9.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu.ops import kernels as JK
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import kernels as TK
from query_engine_tpu_torch.tpch import oracle

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")

# tests/test_correlated_subqueries.py, on employees and departments
CORRELATED = [
    "SELECT e.name FROM employees e WHERE e.salary > "
    "(SELECT AVG(e2.salary) FROM employees e2 WHERE e2.dept_id = e.dept_id) "
    "ORDER BY e.name",
    "SELECT e.name, (SELECT MAX(e2.salary) FROM employees e2 "
    "WHERE e2.dept_id = e.dept_id) AS dept_max FROM employees e ORDER BY e.id",
    "SELECT d.dept_name, (SELECT COUNT(*) FROM employees e "
    "WHERE e.dept_id = d.dept_id) AS n FROM departments d ORDER BY d.dept_id",
    "SELECT d.dept_name FROM departments d WHERE EXISTS "
    "(SELECT 1 FROM employees e WHERE e.dept_id = d.dept_id) "
    "ORDER BY d.dept_name",
    "SELECT d.dept_name FROM departments d WHERE NOT EXISTS "
    "(SELECT 1 FROM employees e WHERE e.dept_id = d.dept_id)",
    "SELECT d.dept_name FROM departments d WHERE EXISTS "
    "(SELECT 1 FROM employees e WHERE e.dept_id = d.dept_id "
    "AND e.age > 30) ORDER BY d.dept_name",
    "SELECT d.dept_id, (SELECT MAX(e.salary) FROM employees e "
    "WHERE e.dept_id = d.dept_id AND e.age < 30) AS m "
    "FROM departments d ORDER BY d.dept_id",
    "SELECT name FROM employees WHERE salary > "
    "(SELECT AVG(salary) FROM employees) ORDER BY name",
    "SELECT name FROM employees e WHERE salary > "
    "(SELECT 1.1 * AVG(salary) FROM employees e2 "
    "WHERE e2.dept_id = e.dept_id) ORDER BY name",
    "SELECT name FROM employees e WHERE salary > "
    "(SELECT SUM(salary) / COUNT(*) FROM employees e2 "
    "WHERE e2.dept_id = e.dept_id) ORDER BY name",
    "SELECT name FROM employees e WHERE EXISTS "
    "(SELECT 1 FROM employees e2 WHERE e2.dept_id = e.dept_id "
    "AND e2.id != e.id) ORDER BY name",
    "SELECT name FROM employees e WHERE NOT EXISTS "
    "(SELECT 1 FROM employees e2 WHERE e2.dept_id = e.dept_id "
    "AND e2.salary > e.salary) ORDER BY name",
    "SELECT name FROM employees e WHERE EXISTS "
    "(SELECT 1 FROM employees e2 WHERE e2.dept_id = e.dept_id "
    "AND e2.age < e.age) ORDER BY name",
    "SELECT name FROM employees e WHERE EXISTS "
    "(SELECT 1 FROM employees e2 WHERE e2.dept_id = e.dept_id "
    "AND e2.id != e.id AND e2.salary >= 90000) ORDER BY name",
    # uncorrelated forms, NULLs and empty sets, DISTINCT aggregates
    "SELECT name FROM employees WHERE dept_id IN "
    "(SELECT dept_id FROM departments WHERE dept_id > 101) ORDER BY name",
    "SELECT name FROM employees WHERE dept_id NOT IN "
    "(SELECT dept_id FROM employees WHERE age > 30) ORDER BY name",
    "SELECT name FROM employees WHERE id NOT IN "
    "(SELECT dept_id FROM employees) ORDER BY name",
    "SELECT name, dept_id IN (SELECT dept_id FROM employees WHERE age < 30) "
    "FROM employees ORDER BY id",
    "SELECT dept_name FROM departments WHERE dept_name IN "
    "(SELECT dept_name FROM departments WHERE dept_id < 103) "
    "ORDER BY dept_name",
    "SELECT name FROM employees WHERE EXISTS "
    "(SELECT 1 FROM departments WHERE dept_id > 200) ORDER BY name",
    "SELECT name FROM employees WHERE NOT EXISTS "
    "(SELECT 1 FROM departments WHERE dept_id > 200) ORDER BY name",
    "SELECT name, (SELECT MAX(age) FROM employees WHERE age > 99) "
    "FROM employees ORDER BY id",
    "SELECT COUNT(DISTINCT dept_id), SUM(DISTINCT age), "
    "AVG(DISTINCT salary) FROM employees",
    "SELECT dept_id, COUNT(DISTINCT age / 10), COUNT(*) FROM employees "
    "GROUP BY dept_id ORDER BY dept_id",
]

QUANTIFIED_TABLES = {
    "t": {"id": [1, 2, 3, 4, 5], "x": [1.0, 5.0, 10.0, None, 7.0]},
    "u": {"y": [5.0, 6.0], "g": [1, 2]},
    "n": {"y": [5.0, None]},
    "an": {"y": [None, None]},
    "sv": {"w": ["b", "d"]},
    "st": {"c": ["a", "c", "e"]},
}

# the subquery cases of tests/test_quantified_cmp.py
QUANTIFIED = [
    "SELECT id, x > ANY (SELECT y FROM u), x > ALL (SELECT y FROM u), "
    "x < SOME (SELECT y FROM u), x <= ALL (SELECT y FROM u) "
    "FROM t ORDER BY id",
    "SELECT id, x = ANY (SELECT y FROM u), x <> ALL (SELECT y FROM u), "
    "x = ALL (SELECT y FROM u WHERE g = 1), "
    "x <> ANY (SELECT y FROM u) FROM t ORDER BY id",
    "SELECT id, x > ANY (SELECT y FROM u WHERE g = 0), "
    "x > ALL (SELECT y FROM u WHERE g = 0) FROM t ORDER BY id",
    "SELECT id, x > ANY (SELECT y FROM n), x > ALL (SELECT y FROM n) "
    "FROM t ORDER BY id",
    "SELECT id, x > ANY (SELECT y FROM an), x > ALL (SELECT y FROM an) "
    "FROM t WHERE id IN (1, 4) ORDER BY id",
    "SELECT c FROM st WHERE c > ALL (SELECT w FROM sv) ORDER BY c",
    "SELECT c, c >= ANY (SELECT w FROM sv) FROM st ORDER BY c",
]

# the cases that must raise, in both packages
RAISING = [
    ("csv",  # a non-equality correlation
     "SELECT e.name FROM employees e WHERE e.salary > "
     "(SELECT AVG(e2.salary) FROM employees e2 WHERE e2.age < e.age)"),
    ("csv",  # a correlated scalar subquery without an aggregate
     "SELECT name FROM employees e WHERE salary > "
     "(SELECT salary FROM employees e2 WHERE e2.dept_id = e.dept_id)"),
    ("csv",  # two inequality correlations
     "SELECT name FROM employees e WHERE EXISTS "
     "(SELECT 1 FROM employees e2 WHERE e2.dept_id = e.dept_id "
     "AND e2.id != e.id AND e2.salary > e.salary)"),
    ("quantified",  # a subquery of two columns
     "SELECT x > ANY (SELECT y, g FROM u) FROM t"),
]


def _register(s, fixture):
    if fixture == "csv":
        s.register_csv("employees", os.path.join(DATA, "employees.csv"))
        s.register_csv("departments", os.path.join(DATA, "departments.csv"))
    else:
        for name, cols in QUANTIFIED_TABLES.items():
            s.register_table(name, cols)


def _run(s, sql):
    try:
        return s.sql(sql).to_pylist()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for fixture in ("csv", "quantified"):
        js = JSession()
        _register(js, fixture)
        out.update({sql: _run(js, sql) for f, sql in CASES + RAISING
                    if f == fixture})
    return out


CASES = [("csv", sql) for sql in CORRELATED] + [
    ("quantified", sql) for sql in QUANTIFIED]


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
@pytest.mark.parametrize("fixture,sql", CASES,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(CASES)])
def test_sql_case_matches_jax(jax_results, fixture, sql, compiled):
    s = Session(device="cpu")
    s.executor._compiled = compiled
    _register(s, fixture)
    want = jax_results[sql]
    assert not isinstance(want, str), want
    got = s.sql(sql).to_pylist()
    oracle.compare(got, want)


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
@pytest.mark.parametrize("fixture,sql", RAISING,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(RAISING)])
def test_sql_case_raises_as_in_jax(jax_results, fixture, sql, compiled):
    """Both packages refuse the query with the same error class (a plan
    error or the planner's ValueError), not with NotImplementedError."""
    s = Session(device="cpu")
    s.executor._compiled = compiled
    _register(s, fixture)
    want = jax_results[sql]
    assert isinstance(want, str) and want != "NotImplementedError", want
    assert _run(s, sql) == want


CAP, N = 512, 451  # rows [N, CAP) are pad rows


def _keys(rng, kind):
    if kind == "i64":
        data = rng.integers(-3, 4, CAP) * (1 << 40)
    elif kind == "i32":
        data = rng.integers(-5, 5, CAP).astype(np.int32)
    else:
        data = rng.integers(-4, 4, CAP) * 0.5
    return data, rng.random(CAP) > 0.15


@pytest.mark.parametrize("kind", ["i64", "i32", "f64"])
@pytest.mark.parametrize("groups", [1, 7])
def test_distinct_first_flags_match_jax(kind, groups):
    rng = np.random.default_rng(len(kind) * 10 + groups)
    data, valid = _keys(rng, kind)
    gid = rng.integers(0, groups, CAP)
    got = TK.distinct_first_flags([torch.from_numpy(data)],
                                  [torch.from_numpy(valid)],
                                  torch.from_numpy(gid), N)
    want = JK.distinct_first_flags([jnp.asarray(data)], [jnp.asarray(valid)],
                                   jnp.asarray(gid), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one flag per live (group, value) pair, NULL one value per group
    live = np.arange(CAP) < N
    pairs = {(g, v if ok else None) for g, v, ok, lv in
             zip(gid, data, valid, live) if lv}
    assert int(got.numpy()[live].sum()) == len(pairs)


@pytest.mark.parametrize("func", ["count", "count_star", "sum", "avg",
                                  "min"])
@pytest.mark.parametrize("kind", ["i64", "f64"])
def test_segment_aggregate_with_dedup_plane_matches_jax(func, kind):
    rng = np.random.default_rng(len(func) + len(kind))
    data, valid = _keys(rng, kind)
    gid = rng.integers(0, 9, CAP)
    first = JK.distinct_first_flags([jnp.asarray(data)], [jnp.asarray(valid)],
                                    jnp.asarray(gid), N)
    jv, jok = JK.segment_aggregate(func, jnp.asarray(data),
                                   jnp.asarray(valid), jnp.asarray(gid), N,
                                   16, distinct_first=first)
    pv, pok = TK.segment_aggregate(
        func, torch.from_numpy(data), torch.from_numpy(valid),
        torch.from_numpy(gid), N, 16,
        distinct_first=torch.from_numpy(np.array(first)))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    np.testing.assert_allclose(pv.numpy()[ok], np.asarray(jv)[ok],
                               rtol=1e-12)


@pytest.mark.parametrize("cap_l,cap_r", [(512, 128), (128, 512)])
def test_rank_member_matches_jax(cap_l, cap_r):
    rng = np.random.default_rng(cap_l)
    n_ranks = cap_l + cap_r
    lr = rng.integers(-3, 60, cap_l)
    lr[lr < 0] = -(np.arange(cap_l)[lr < 0] + 2)  # NULL keys: unique < 0
    rr = rng.integers(-2, 60, cap_r)
    rr[rr < 0] = -(np.arange(cap_r)[rr < 0] + cap_l + 2)
    r_live = np.arange(cap_r) < cap_r - 17  # pad rows on the right
    got = TK.rank_member(torch.from_numpy(lr), torch.from_numpy(rr),
                         torch.from_numpy(r_live))
    want = JK.rank_member(jnp.asarray(lr), jnp.asarray(rr),
                          jnp.asarray(r_live), n_ranks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    members = set(rr[r_live & (rr >= 0)])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray([x >= 0 and x in members for x in lr]))
