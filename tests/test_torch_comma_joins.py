"""Comma joins and the SQL standard's spellings that TPC-H's texts use, on
the port's Session on the CPU over `benchmarks/tpch_mini.build(1 << 11)`:

* `INTERVAL '<n>' DAY|MONTH|YEAR [(p)]`, `SUBSTRING(x FROM s [FOR n])` and
  a derived table's column list give the rows of their older spellings;
* a decimal literal sum folds exactly (TPC-H Q6's `.06 + 0.01` is 0.07);
* FROM lists joined by WHERE equalities (the specification's Q2, Q3, Q5,
  Q8, Q14, Q17, Q19 and Q21 shapes) give the rows of their `JOIN ... ON`
  spellings, with the compiled pipeline on and off, and those of the JAX
  package (which runs them as CROSS joins, so it runs the two-table ones
  as written and the others in their `JOIN ... ON` spelling);
* EXPLAIN shows no CROSS join where the WHERE clause connects the items,
  and keeps it where nothing does; SSB's 13 texts plan as they did before
  the comma-join rule;
* the pipeline's `like_ms`, `like_values` and `cross_joins` count on an
  eager and a compiled run, LIKE's ms come out of an enclosing leaf's, and
  EXPLAIN ANALYZE prints each statement's change of them.

Integers, strings and dates must match exactly; floats to rtol 1e-9.
"""

import time

import pytest

from benchmarks import tpch_mini
from query_engine_tpu_torch.core.errors import PlanError
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.plan import optimizer as opt
from query_engine_tpu_torch.tpch import data, oracle, queries

N_LI = 1 << 11

# the specification's comma-join shapes, each over tpch_mini's columns and
# literals: {name: (comma text, the same query in tpch_mini's JOIN ... ON
# spelling)}
COMMA = {
    "Q3": (
        "SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS "
        "revenue, o_orderdate, o_shippriority "
        "FROM customer, orders, lineitem "
        "WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey "
        "AND l_orderkey = o_orderkey AND o_orderdate < '1995-03-15' "
        "AND l_shipdate > '1995-03-15' "
        "GROUP BY l_orderkey, o_orderdate, o_shippriority "
        "ORDER BY revenue DESC LIMIT 10",
        queries.QUERIES["Q3"]),
    "Q5": (
        "SELECT n_name, SUM(l_extendedprice * (1 - l_discount)) AS revenue "
        "FROM customer, orders, lineitem, supplier, nation, region "
        "WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey "
        "AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey "
        "AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey "
        "AND r_name = 'ASIA' AND o_orderdate >= '1994-01-01' "
        "AND o_orderdate < '1995-01-01' "
        "GROUP BY n_name ORDER BY revenue DESC",
        queries.QUERIES["Q5"]),
    "Q8": (
        "SELECT o_year, SUM(CASE WHEN nation = 'NATION05' THEN volume "
        "ELSE 0 END) / SUM(volume) AS mkt_share "
        "FROM (SELECT EXTRACT(year FROM o_orderdate) AS o_year, "
        "l_extendedprice * (1 - l_discount) AS volume, n2.n_name AS nation "
        "FROM part, supplier, lineitem, orders, customer, nation n1, "
        "nation n2, region "
        "WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey "
        "AND l_orderkey = o_orderkey AND o_custkey = c_custkey "
        "AND c_nationkey = n1.n_nationkey AND n1.n_regionkey = r_regionkey "
        "AND r_name = 'AMERICA' AND s_nationkey = n2.n_nationkey "
        "AND o_orderdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31' "
        "AND p_type = 'ECONOMY ANODIZED STEEL') AS all_nations "
        "GROUP BY o_year ORDER BY o_year",
        queries.QUERIES["Q8"]),
    "Q14": (
        "SELECT 100.00 * SUM(CASE WHEN p_type LIKE 'PROMO%' "
        "THEN l_extendedprice * (1 - l_discount) ELSE 0 END) / "
        "SUM(l_extendedprice * (1 - l_discount)) AS promo_revenue "
        "FROM lineitem, part WHERE l_partkey = p_partkey "
        "AND l_shipdate >= '1995-09-01' AND l_shipdate < '1995-10-01'",
        queries.QUERIES["Q14"]),
    "Q17": (
        "SELECT SUM(l_extendedprice) / 7.0 AS avg_yearly FROM lineitem, part "
        "WHERE p_partkey = l_partkey AND p_brand = 'Brand#23' "
        "AND p_container = 'MED BOX' AND l_quantity < (SELECT 0.2 * "
        "AVG(l2.l_quantity) FROM lineitem l2 WHERE l2.l_partkey = "
        "p_partkey)",
        queries.QUERIES["Q17"]),
    "Q19": (
        "SELECT SUM(l_extendedprice * (1 - l_discount)) AS revenue "
        "FROM lineitem, part WHERE (p_partkey = l_partkey "
        "AND p_brand = 'Brand#12' AND p_container IN ('SM CASE', 'SM BOX') "
        "AND l_quantity BETWEEN 1 AND 11 AND p_size BETWEEN 1 AND 5 "
        "AND l_shipmode IN ('AIR', 'REG AIR')) OR (p_partkey = l_partkey "
        "AND p_brand = 'Brand#23' AND p_container IN ('MED BAG', 'MED BOX') "
        "AND l_quantity BETWEEN 10 AND 20 AND p_size BETWEEN 1 AND 10 "
        "AND l_shipmode IN ('AIR', 'REG AIR')) OR (p_partkey = l_partkey "
        "AND p_brand = 'Brand#34' AND p_container IN ('LG CASE', 'LG BOX') "
        "AND l_quantity BETWEEN 20 AND 30 AND p_size BETWEEN 1 AND 15 "
        "AND l_shipmode IN ('AIR', 'REG AIR'))",
        queries.QUERIES["Q19"]),
    "Q21": (
        "SELECT s_name, COUNT(*) AS numwait "
        "FROM supplier, lineitem l1, orders, nation "
        "WHERE s_suppkey = l1.l_suppkey AND o_orderkey = l1.l_orderkey "
        "AND l1.l_receiptdate > l1.l_commitdate "
        "AND EXISTS (SELECT 1 FROM lineitem l2 "
        "WHERE l2.l_orderkey = l1.l_orderkey "
        "AND l2.l_suppkey != l1.l_suppkey) "
        "AND NOT EXISTS (SELECT 1 FROM lineitem l3 "
        "WHERE l3.l_orderkey = l1.l_orderkey "
        "AND l3.l_suppkey != l1.l_suppkey "
        "AND l3.l_receiptdate > l3.l_commitdate) "
        "AND s_nationkey = n_nationkey AND n_name = 'NATION04' "
        "GROUP BY s_name ORDER BY numwait DESC, s_name LIMIT 100",
        queries.QUERIES["Q21"]),
    "Q2": (
        "SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr "
        "FROM part, partsupp, supplier, nation, region "
        "WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey "
        "AND p_size = 15 AND p_type LIKE '%TIN' "
        "AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey "
        "AND r_name = 'EUROPE' AND ps_supplycost = ("
        "SELECT MIN(ps2.ps_supplycost) FROM partsupp ps2, supplier s2, "
        "nation n2, region r2 WHERE s2.s_suppkey = ps2.ps_suppkey "
        "AND s2.s_nationkey = n2.n_nationkey "
        "AND n2.n_regionkey = r2.r_regionkey "
        "AND ps2.ps_partkey = p_partkey AND r2.r_name = 'EUROPE') "
        "ORDER BY s_acctbal DESC, n_name, s_name, p_partkey LIMIT 100",
        queries.QUERIES["Q2"]),
}
# the two-table shapes the JAX package runs as written (CROSS, then filter)
JAX_AS_WRITTEN = ("Q14", "Q17", "Q19")


@pytest.fixture(scope="module")
def jax_session():
    js, _ = tpch_mini.build(N_LI)
    return js


@pytest.fixture(scope="module")
def host_tables():
    return data.generate(N_LI)


def _session(tables, compiled=True):
    s = Session(device="cpu")
    s.executor._compiled = compiled
    data.register(s, tables)
    return s


@pytest.fixture(scope="module")
def session(host_tables):
    return _session(host_tables)


def _plan(session, text):
    return "\n".join(r[0] for r in session.sql("EXPLAIN " + text).to_pylist())


# ---- the standard's spellings -------------------------------------------

SPELLINGS = {
    "interval_day": (
        "SELECT COUNT(*) FROM lineitem WHERE l_shipdate <= "
        "date '1998-12-01' - interval '90' day (3)",
        "SELECT COUNT(*) FROM lineitem WHERE l_shipdate <= "
        "date '1998-12-01' - interval '90 days'"),
    "interval_month": (
        "SELECT COUNT(*) FROM orders WHERE o_orderdate >= date '1993-07-01' "
        "AND o_orderdate < date '1993-07-01' + interval '3' month",
        "SELECT COUNT(*) FROM orders WHERE o_orderdate >= date '1993-07-01' "
        "AND o_orderdate < date '1993-07-01' + interval '3 months'"),
    "interval_year": (
        "SELECT COUNT(*) FROM orders WHERE o_orderdate < "
        "date '1994-01-01' + interval '1' year",
        "SELECT COUNT(*) FROM orders WHERE o_orderdate < "
        "date '1994-01-01' + interval '1 year'"),
    "substring_from_for": (
        "SELECT SUBSTRING(c_phone FROM 1 FOR 2) AS cc, COUNT(*) "
        "FROM customer GROUP BY SUBSTRING(c_phone FROM 1 FOR 2) "
        "ORDER BY cc",
        "SELECT SUBSTRING(c_phone, 1, 2) AS cc, COUNT(*) "
        "FROM customer GROUP BY SUBSTRING(c_phone, 1, 2) ORDER BY cc"),
    "substring_from": (
        "SELECT SUBSTRING(s_name FROM 10) AS t FROM supplier ORDER BY t",
        "SELECT SUBSTRING(s_name, 10) AS t FROM supplier ORDER BY t"),
    "derived_columns": (
        "SELECT c_count, COUNT(*) AS custdist FROM (SELECT c_custkey, "
        "COUNT(o_orderkey) FROM customer LEFT OUTER JOIN orders ON "
        "c_custkey = o_custkey GROUP BY c_custkey) AS c_orders "
        "(c_custkey, c_count) GROUP BY c_count ORDER BY custdist DESC, "
        "c_count DESC",
        "SELECT c_count, COUNT(*) AS custdist FROM (SELECT c_custkey, "
        "COUNT(o_orderkey) AS c_count FROM customer LEFT OUTER JOIN orders "
        "ON c_custkey = o_custkey GROUP BY c_custkey) AS c_orders "
        "GROUP BY c_count ORDER BY custdist DESC, c_count DESC"),
    "decimal_sum": (
        "SELECT COUNT(*) FROM lineitem "
        "WHERE l_discount BETWEEN .06 - 0.01 AND .06 + 0.01",
        "SELECT COUNT(*) FROM lineitem "
        "WHERE l_discount BETWEEN 0.05 AND 0.07"),
}


@pytest.mark.parametrize("form", sorted(SPELLINGS))
def test_spelling_gives_the_older_spellings_rows(session, form):
    new, old = SPELLINGS[form]
    got = session.sql(new).to_pylist()
    assert got == session.sql(old).to_pylist()
    assert got and got != [(0,)]


def test_derived_column_list_of_the_wrong_arity():
    s = Session(device="cpu")
    with pytest.raises(PlanError, match="2 columns but 3 names"):
        s.sql("SELECT * FROM (SELECT 1 AS a, 2 AS b) AS t (x, y, z)")


def test_decimal_literal_sum_is_exact():
    s = Session(device="cpu")
    assert s.sql("SELECT .06 + 0.01 AS a, .06 - 0.01 AS b, "
                 ".06 + 0.01 + 0 AS c, 1 + 2 AS d").to_pylist() \
        == [(0.07, 0.05, 0.07, 3)]
    # a bound parameter is a DOUBLE (PostgreSQL's float8): its sum folds
    # in floats, as refresh.Q6_PARAM's tests hold
    assert s.sql("SELECT $1 + 0.01 AS a, $1 + 0.01 + 0 AS b",
                 params=[0.06]).to_pylist() \
        == [(0.06 + 0.01, 0.06 + 0.01)]
    assert 0.06 + 0.01 != 0.07


def test_decimal_literal_sum_departs_from_the_jax_package(session,
                                                          jax_session):
    """The JAX package folds `.06 + 0.01` in floats, to 0.06999999999999999,
    and so drops Q6's 0.07 discounts, which the port keeps."""
    text = ("SELECT COUNT(*) FROM lineitem "
            "WHERE l_discount BETWEEN .06 - 0.01 AND .06 + 0.01")
    at = ("SELECT COUNT(*) FROM lineitem WHERE l_discount = 0.07")
    assert jax_session.sql("SELECT .06 + 0.01 AS a").to_pylist() \
        == [(0.06999999999999999,)]
    ((ours,),) = session.sql(text).to_pylist()
    ((theirs,),) = jax_session.sql(text).to_pylist()
    ((sevens,),) = session.sql(at).to_pylist()
    assert sevens > 0
    assert ours - theirs == sevens


# ---- comma joins ---------------------------------------------------------

@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
@pytest.mark.parametrize("q", sorted(COMMA))
def test_comma_join_gives_the_join_on_rows(host_tables, q, compiled):
    s = _session(host_tables, compiled)
    comma, join_on = COMMA[q]
    oracle.compare(s.sql(comma).to_pylist(), s.sql(join_on).to_pylist())


@pytest.mark.parametrize("q", sorted(COMMA))
def test_comma_join_gives_the_jax_packages_rows(session, jax_session, q):
    comma, join_on = COMMA[q]
    want = jax_session.sql(comma if q in JAX_AS_WRITTEN
                           else join_on).to_pylist()
    oracle.compare(session.sql(comma).to_pylist(), want)


@pytest.mark.parametrize("q", sorted(COMMA))
def test_connected_items_plan_no_cross_join(session, q):
    plan = _plan(session, COMMA[q][0])
    assert "Join: CROSS" not in plan
    assert "Join: INNER" in plan


def test_items_nothing_connects_stay_cross(session):
    text = ("SELECT n_name, r_name FROM nation, region "
            "WHERE r_name = 'ASIA' AND n_nationkey < 3")
    plan = _plan(session, text)
    assert "Join: CROSS" in plan
    # each item's own conjunct filters that item below the join
    assert plan.index("Join: CROSS") < plan.index("Filter: region")
    assert len(session.sql(text).to_pylist()) == 3


def test_fact_table_probes_and_dimensions_build(session):
    """Items join largest first: lineitem is the left-most scan, and each
    dimension is the right side of the join that brings it in."""
    plan = _plan(session, COMMA["Q5"][0])
    scans = [line.strip() for line in plan.splitlines()
             if "TableScan" in line]
    assert scans[0] == "TableScan: lineitem"
    assert "lineitem.l_suppkey = supplier.s_suppkey AND " \
           "customer.c_nationkey = supplier.s_nationkey" in plan


def test_or_branches_give_up_their_common_join_key(session):
    plan = _plan(session, COMMA["Q19"][0])
    assert "Join: INNER on lineitem.l_partkey = part.p_partkey" in plan \
        or "Join: INNER on part.p_partkey = lineitem.l_partkey" in plan


SSB_TINY = {"sizes": {"customer": 60, "supplier": 8, "part": 160,
                      "orders": 300, "lineorder": 1200, "date": 2556}}


def test_ssb_texts_plan_as_before():
    """SSB's explicit JOIN ... ON texts take no new path: their plans equal
    those of the optimizer without the comma-join rule, and hold no CROSS
    join."""
    from pathlib import Path

    from port_bench import run
    from port_bench.data import ssb

    root = Path(__file__).resolve().parents[1]
    s = Session(device="cpu")
    run.register(s, ssb.generate(SSB_TINY, 7, "cpu"), "cpu")
    texts = sorted((root / "port_bench" / "queries" / "ssb").glob("*.sql"))
    assert len(texts) == 13
    before = opt.Optimizer(rules=[opt.PredicatePushdown(),
                                  opt.ProjectionPushdown()])
    for path in texts:
        text = path.read_text()
        plan = _plan(s, text)
        assert "CROSS" not in plan, path.name
        s.optimizer, now = before, s.optimizer
        try:
            assert _plan(s, text) == plan, path.name
        finally:
            s.optimizer = now


# each SSB statement's FK build columns gathered and left out, at SSB_TINY
# and seed 7: as the parent commit of the comma-join rule gathered them, so
# the projections' demand rule changes no SSB program
SSB_FK_COLS = {
    "Q1.1": (0, 17), "Q1.2": (0, 17), "Q1.3": (0, 17),
    "Q2.1": (2, 31), "Q2.2": (2, 31), "Q2.3": (2, 31),
    "Q3.1": (3, 29), "Q3.2": (3, 29), "Q3.3": (3, 29), "Q3.4": (3, 29),
    "Q4.1": (2, 39), "Q4.2": (3, 38), "Q4.3": (3, 38)}


def test_ssb_programs_gather_as_before():
    from pathlib import Path

    from port_bench import run
    from port_bench.data import ssb

    root = Path(__file__).resolve().parents[1]
    s = Session(device="cpu")
    run.register(s, ssb.generate(SSB_TINY, 7, "cpu"), "cpu")
    st = s.executor.pipeline.stats
    got = {}
    for path in sorted((root / "port_bench" / "queries" / "ssb")
                       .glob("*.sql")):
        before = (st["fk_cols_gathered"], st["fk_cols_pruned"])
        s.sql(path.read_text()).to_pylist()
        got[path.stem] = (st["fk_cols_gathered"] - before[0],
                          st["fk_cols_pruned"] - before[1])
    assert got == SSB_FK_COLS


# ---- counters --------------------------------------------------------------

LIKE = ("SELECT COUNT(*) FROM part WHERE p_name LIKE '%green%' "
        "AND p_type LIKE 'PROMO%'")


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
def test_like_and_cross_join_counters(host_tables, compiled):
    s = _session(host_tables, compiled)
    st = s.executor.pipeline.stats
    names = s.sql("SELECT COUNT(*) FROM (SELECT DISTINCT p_name FROM part) "
                  "AS t").to_pylist()[0][0]
    types = s.sql("SELECT COUNT(*) FROM (SELECT DISTINCT p_type FROM part) "
                  "AS t").to_pylist()[0][0]
    before = dict(st)
    s.sql(LIKE).to_pylist()
    assert st["like_values"] - before["like_values"] == names + types
    assert st["like_ms"] > before["like_ms"]
    assert st["cross_joins"] == before["cross_joins"]
    s.sql(COMMA["Q5"][0]).to_pylist()
    assert st["cross_joins"] == before["cross_joins"]
    s.sql("SELECT COUNT(*) FROM nation, region").to_pylist()
    assert st["cross_joins"] == before["cross_joins"] + 1


def test_like_ms_leave_the_enclosing_leaf():
    s = Session(device="cpu")
    p = s.executor.pipeline
    with p.phase("leaf", "leaf_ms") as leaf:
        p._leaf_depth += 1
        try:
            with p.like_phase(7):
                time.sleep(0.02)
        finally:
            p._leaf_depth -= 1
    assert p.stats["like_values"] == 7
    assert p.stats["like_ms"] >= 20
    assert p.stats["leaf_ms"] == pytest.approx(leaf.ms - p.stats["like_ms"])
    assert 0 <= p.stats["leaf_ms"] < leaf.ms


def test_explain_analyze_prints_the_new_counters(session):
    lines = [r[0] for r in session.sql("EXPLAIN ANALYZE " + LIKE).to_pylist()]
    (line,) = [x for x in lines if x.startswith("pipeline:")]
    assert "like_ms=" in line and "cross_joins=0" in line
    assert "like_values=" in line and "like_values=0 " not in line
