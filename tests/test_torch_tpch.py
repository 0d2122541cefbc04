"""The port's TPC-H subpackage and the twelve subquery-free TPC-H queries,
against the JAX package at `benchmarks/tpch_mini.build(1 << 11)`.

* `tpch.data.generate` gives the tables of `tpch_mini.build`: every plane,
  validity bit and dictionary of all eight tables;
* each of the twelve queries gives the JAX Session's rows, in order, through
  the port's Session on the CPU, with the compiled pipeline on (the default)
  and off (QE_COMPILED=0);
* each numpy oracle of `tpch.oracle` gives the JAX Session's rows;
* Q6 and Q14 with their date literals a year later, on the Session that
  already ran them, reuse its program and give the shifted oracle's rows;
* the ten queries with subqueries still raise NotImplementedError.

Integers, strings and dates must match exactly; floats to rtol 1e-9.
"""

import numpy as np
import pytest

from benchmarks import tpch_mini
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import data, oracle, queries

N_LI = 1 << 11
TABLES = ["customer", "orders", "lineitem", "supplier", "nation", "region",
          "part", "partsupp"]
OUTSIDE = ["Q2", "Q4", "Q11", "Q15", "Q16", "Q17", "Q18", "Q20", "Q21",
           "Q22"]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX Session over tpch_mini's tables, and the tables by name."""
    js, batches = tpch_mini.build(N_LI)
    return js, dict(zip(TABLES, batches))


@pytest.fixture(scope="module")
def jax_rows(jax_side):
    js, _ = jax_side
    return {q: js.sql(text).to_pylist() for q, text in queries.QUERIES.items()}


@pytest.fixture(scope="module")
def host_tables():
    return data.generate(N_LI)


def _session(tables, compiled=True):
    s = Session(device="cpu")
    s.executor._compiled = compiled
    data.register(s, tables)
    return s


def test_queries_are_tpch_minis():
    assert set(queries.QUERIES) == set(oracle.ORACLES)
    assert set(queries.QUERIES) | set(OUTSIDE) == set(tpch_mini.QUERIES)
    for q, text in queries.QUERIES.items():
        assert text == tpch_mini.QUERIES[q]


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_tpch_mini(jax_side, host_tables, name):
    _, jt = jax_side
    want = jt[name]
    got = host_tables[name].to_batch("cpu")
    assert got.num_rows == want.num_rows
    assert got.schema.names() == want.schema.names()
    for f, a, b in zip(want.schema, got.columns, want.columns):
        assert str(a.dtype) == str(b.dtype), f.name
        da, db = a.data.numpy(), np.asarray(b.data)
        assert da.dtype == db.dtype and np.array_equal(da, db), f.name
        assert np.array_equal(a.validity.numpy(), np.asarray(b.validity)), \
            f.name
        if b.dictionary is None:
            assert a.dictionary is None, f.name
        else:
            assert list(a.dictionary.values) == list(b.dictionary.values), \
                f.name


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
@pytest.mark.parametrize("q", list(queries.QUERIES))
def test_query_matches_jax(jax_rows, host_tables, q, compiled):
    s = _session(host_tables, compiled)
    got = s.sql(queries.QUERIES[q]).to_pylist()
    oracle.compare(got, jax_rows[q])  # same order, floats at rtol 1e-9
    stats = s.executor.pipeline.stats
    if compiled:
        assert stats["compiles"] >= 1 and stats["fallbacks"] == 0, stats
    else:
        assert stats["compiles"] == 0, stats


@pytest.mark.parametrize("q", list(queries.QUERIES))
def test_oracle_matches_jax(jax_rows, host_tables, q):
    want = jax_rows[q]
    oracle.compare(oracle.run(q, host_tables), want)
    if q != "Q7":  # no NATION01/NATION02 trade at this size
        assert want


def test_q7_with_rows_matches_jax():
    """Q7 has no rows at 2^11 lineitem rows; at 2^13 it has some."""
    js, _ = tpch_mini.build(1 << 13)
    want = js.sql(queries.QUERIES["Q7"]).to_pylist()
    assert want
    tables = data.generate(1 << 13)
    for compiled in (True, False):
        got = _session(tables, compiled).sql(queries.QUERIES["Q7"])
        oracle.compare(got.to_pylist(), want)
    oracle.compare(oracle.run("Q7", tables), want)


def test_oracles_see_rows_at_a_larger_size():
    """At 2^14 lineitem rows every query has rows, Q7 included; the
    oracle's rows agree with themselves under compare."""
    tables = data.generate(1 << 14)
    for q in queries.QUERIES:
        rows = oracle.run(q, tables)
        assert rows and all(v is not None for r in rows for v in r), q
        assert oracle.compare(rows, rows) == 0.0


def test_compare_allows_only_float_ties_to_swap():
    want = [(1, 2.0), (2, 2.0 * (1 + 1e-12)), (3, 1.0)]
    swapped = [want[1], want[0], want[2]]
    oracle.compare(swapped, want, float_keys=(1,))
    with pytest.raises(AssertionError):
        oracle.compare(swapped, want)
    with pytest.raises(AssertionError):
        oracle.compare([(1, 2.0), (2, 2.0), (3, 1.0 + 1e-6)], want)
    with pytest.raises(AssertionError):
        oracle.compare([(1, 2.0), (2, 2.0)], want)


@pytest.mark.parametrize("q", list(queries.SHIFTED))
def test_shifted_literals_rerun_on_one_session(jax_side, host_tables, q):
    """A program keyed on a date literal takes the literal as an input: the
    shifted query hits the same program and reads the new dates."""
    js, _ = jax_side
    s = _session(host_tables)
    first = s.sql(queries.QUERIES[q]).to_pylist()
    oracle.compare(first, oracle.run(q, host_tables))
    stats = dict(s.executor.pipeline.stats)
    got = s.sql(queries.SHIFTED[q]).to_pylist()
    want = oracle.shifted(host_tables)[q]
    assert got != first
    oracle.compare(got, want)
    oracle.compare(got, js.sql(queries.SHIFTED[q]).to_pylist())
    after = s.executor.pipeline.stats
    assert after["compiles"] == stats["compiles"], after
    assert after["hits"] == stats["hits"] + 1, after


def _graph_admission_session(tables):
    """A CPU Session whose pipeline admits nodes as on CUDA, where a program
    is captured into a graph: a node that builds a host table (a string
    comparison, LIKE, string IN) is an eager leaf. The capture itself is
    skipped, so each call runs the program body."""
    s = _session(tables)
    s.executor.pipeline._graphs = True
    s.executor.pipeline._capture = lambda *args: None
    return s


@pytest.mark.parametrize("q", list(queries.QUERIES))
def test_query_under_graph_admission(host_tables, q):
    s = _graph_admission_session(host_tables)
    want = oracle.run(q, host_tables)
    for _ in range(2):
        oracle.compare(s.sql(queries.QUERIES[q]).to_pylist(), want)
    stats = s.executor.pipeline.stats
    assert stats["compiles"] >= 1 and stats["hits"] >= 1, stats
    assert stats["fallbacks"] == 0, stats


@pytest.mark.parametrize("q", ["Q1", "Q6"])
def test_date_filters_compile_whole_under_graph_admission(host_tables, q):
    """A date compared with a string literal is a program input, not a
    dictionary merge: Q1 and Q6 run as one program with one host read, and
    the shifted Q6 replays that program."""
    s = _graph_admission_session(host_tables)
    s.sql(queries.QUERIES[q]).to_pylist()
    syncs = s.executor.host_syncs
    s.sql(queries.QUERIES[q]).to_pylist()
    assert s.executor.host_syncs == syncs + 1
    if q in queries.SHIFTED:
        got = s.sql(queries.SHIFTED[q]).to_pylist()
        oracle.compare(got, oracle.shifted(host_tables)[q])
    stats = s.executor.pipeline.stats
    assert stats["compiles"] == 1 and stats["fallbacks"] == 0, stats


@pytest.mark.parametrize("q,leaves", [("Q6", []), ("Q3", ["Filter"]),
                                      ("Q13", ["HashJoin"])])
def test_eager_leaves_are_counted_and_timed(host_tables, q, leaves):
    """The pipeline records each eager leaf's node type and the host time
    spent in the outermost ones."""
    s = _graph_admission_session(host_tables)
    s.sql(queries.QUERIES[q]).to_pylist()
    pipe = s.executor.pipeline
    assert sorted(pipe.leaf_kinds) == leaves, pipe.leaf_kinds
    assert (pipe.stats["leaf_ms"] > 0) == bool(leaves), pipe.stats
    assert pipe.stats["capture_ms"] == 0, pipe.stats  # capture stubbed


@pytest.mark.parametrize("q", OUTSIDE)
def test_queries_with_subqueries_raise(host_tables, q):
    s = _session(host_tables)
    with pytest.raises(NotImplementedError):
        s.sql(tpch_mini.QUERIES[q]).to_pylist()
