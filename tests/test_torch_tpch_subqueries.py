"""The ten TPC-H queries with subqueries (Q2, Q4, Q11, Q15, Q16, Q17, Q18,
Q20, Q21, Q22) through the port, against the JAX package at
`benchmarks/tpch_mini.build(1 << 11)`:

* each gives the JAX Session's rows through the port's Session on the CPU,
  with the compiled pipeline on (the default) and off (QE_COMPILED=0);
* each numpy oracle of `tpch.oracle` gives the JAX Session's rows;
* each runs twice under the card's admission rule (a program that would
  build a host table is an eager leaf; the capture is stubbed), equals
  the oracle both times and compiles nothing the second time;
* Q2, Q20 and Q21 have no rows at 2^11 lineitem rows, so each is held
  again at the smallest power of two where it has some;
* a WITH query referenced more than once is executed once per query, and Q15's
  MAX is bit for bit the total of the row it selects.

Integers, strings and dates must match exactly; floats to rtol 1e-9.
"""

import struct

import pytest

from benchmarks import tpch_mini
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.plan import physical as pp
from query_engine_tpu_torch.tpch import data, oracle, queries

N_LI = 1 << 11
# the queries without rows at N_LI, and a size where each has some
WITH_ROWS = {"Q2": 1 << 12, "Q20": 1 << 14, "Q21": 1 << 15}


@pytest.fixture(scope="module")
def jax_rows():
    js, _ = tpch_mini.build(N_LI)
    return {q: js.sql(queries.QUERIES[q]).to_pylist()
            for q in queries.WITH_SUBQUERIES}


@pytest.fixture(scope="module")
def host_tables():
    return data.generate(N_LI)


def _session(tables, compiled=True):
    s = Session(device="cpu")
    s.executor._compiled = compiled
    data.register(s, tables)
    return s


def _keys(q):
    return oracle.FLOAT_SORT_KEYS.get(q, ())


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
@pytest.mark.parametrize("q", queries.WITH_SUBQUERIES)
def test_query_matches_jax(jax_rows, host_tables, q, compiled):
    s = _session(host_tables, compiled)
    got = s.sql(queries.QUERIES[q]).to_pylist()
    oracle.compare(got, jax_rows[q], _keys(q))
    stats = s.executor.pipeline.stats
    if compiled:
        assert stats["compiles"] >= 1 and stats["fallbacks"] == 0, stats
    else:
        assert stats["compiles"] == 0, stats


@pytest.mark.parametrize("q", queries.WITH_SUBQUERIES)
def test_oracle_matches_jax(jax_rows, host_tables, q):
    want = jax_rows[q]
    oracle.compare(oracle.run(q, host_tables), want, _keys(q))
    assert bool(want) == (q not in WITH_ROWS)


@pytest.mark.parametrize("q", queries.WITH_SUBQUERIES)
def test_query_under_graph_admission(host_tables, q):
    """As on CUDA: SUBSTRING, LIKE, string comparisons and string-keyed
    subqueries are eager leaves; the subquery batches are program inputs.
    The capture is skipped, so each call runs the program body."""
    s = _session(host_tables)
    s.executor.pipeline._graphs = True
    s.executor.pipeline._capture = lambda *args: None
    want = oracle.run(q, host_tables)
    compiles = []
    for _ in range(2):
        oracle.compare(s.sql(queries.QUERIES[q]).to_pylist(), want, _keys(q))
        compiles.append(s.executor.pipeline.stats["compiles"])
    stats = s.executor.pipeline.stats
    assert stats["compiles"] >= 1 and stats["hits"] >= 1, stats
    assert stats["fallbacks"] == 0, stats
    # the second run compiles nothing: every program key repeats (a
    # SUBSTRING's result dictionary is the same object on every query)
    assert compiles[1] == compiles[0], stats


@pytest.mark.parametrize("q", list(WITH_ROWS))
def test_query_with_rows_matches_jax(q):
    n = WITH_ROWS[q]
    js, _ = tpch_mini.build(n)
    want = js.sql(queries.QUERIES[q]).to_pylist()
    assert want
    tables = data.generate(n)
    for compiled in (True, False):
        got = _session(tables, compiled).sql(queries.QUERIES[q]).to_pylist()
        oracle.compare(got, want, _keys(q))
    oracle.compare(oracle.run(q, tables), want, _keys(q))


def _shared_runs(session):
    """Spy on the executor: how many times the input of a shared WITH query
    was executed (the memo should make it once per query)."""
    ex = session.executor
    inner = ex.execute
    shared, runs = set(), []

    def execute(plan):
        if isinstance(plan, pp.PSubquery) and plan.shared:
            shared.add(id(plan.input))
        if id(plan) in shared:
            runs.append(plan)
        return inner(plan)

    ex.execute = execute
    return runs


CTE = ("WITH t AS (SELECT k, SUM(v) AS s FROM x GROUP BY k) "
       "SELECT a.k, a.s FROM t a JOIN t b ON a.k = b.k "
       "WHERE a.s = (SELECT MAX(s) FROM t) ORDER BY a.k")


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
def test_cte_referenced_three_times_runs_once(compiled):
    s = Session(device="cpu")
    s.executor._compiled = compiled
    s.register_table("x", ColumnBatch.from_pydict({
        "k": [1, 2, 3, 1, 2, 3, 3], "v": [0.1, 0.2, 0.3, 0.2, 0.1, 0.05,
                                          0.05]}))
    runs = _shared_runs(s)
    for n in (1, 2):
        assert s.sql(CTE).to_pylist() == [(3, 0.3 + 0.05 + 0.05)]
        assert len(runs) == n
    assert not s.executor._cte_memo  # cleared after the query
    assert not s.executor.evaluator._corr_match_memo


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
def test_q15_max_is_a_row_bit_for_bit(host_tables, compiled):
    s = _session(host_tables, compiled)
    runs = _shared_runs(s)
    rows = s.sql(queries.QUERIES["Q15"]).to_pylist()
    assert len(runs) == 1
    oracle.compare(rows, oracle.run("Q15", host_tables))
    cte = queries.QUERIES["Q15"].split(" SELECT s.s_suppkey")[0]
    ((top,),) = s.sql(cte + " SELECT MAX(total_revenue) FROM revenue"
                      ).to_pylist()
    assert rows and all(struct.pack("<d", r[2]) == struct.pack("<d", top)
                        for r in rows)
