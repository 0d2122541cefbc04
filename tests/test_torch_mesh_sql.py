"""The mesh pipeline of the port against the JAX package: every case of
tests/test_mesh_sql.py, with its tables and queries.

Each query runs through the JAX single-device Session, the JAX Session on
the 8 virtual CPU devices, and the port's `Session(device="cpu",
mesh=make_mesh(["cpu"] * 8))` (tests/torch_mesh_diff.py). The port's rows
must equal the JAX single-device rows, exactly, or as sets where the JAX
case compares sets, or within the JAX case's own `float_tol`; the change in
the port's `mesh_pipeline.stats` over the query must equal the JAX mesh's
(compiles, hits, fallbacks, exchanges, overflow retries, joins counted,
eager leaves, partial/final aggregates). The JAX file's slow cases are
slow here too.
"""

import numpy as np
import pytest

from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.parallel.mesh import make_mesh
from torch_mesh_diff import MeshTrio, check, port_mesh, same_rows

RNG = np.random.default_rng(7)
N_ORDERS = 4000
ORDERS = {
    "o_id": list(range(N_ORDERS)),
    "cust": RNG.integers(0, 60, N_ORDERS).tolist(),
    "amount": RNG.integers(1, 1000, N_ORDERS).tolist(),
    "tag": RNG.choice(["red", "green", "blue", "cyan"], N_ORDERS).tolist(),
    "score": RNG.normal(50, 10, N_ORDERS).round(3).tolist(),
}
# sprinkle NULLs
for i in range(0, N_ORDERS, 97):
    ORDERS["cust"][i] = None
for i in range(0, N_ORDERS, 131):
    ORDERS["amount"][i] = None
CUSTOMERS = {
    "c_id": list(range(60)),
    "region": RNG.integers(0, 6, 60).tolist(),
    "name": [f"cust_{i:03d}" for i in range(60)],
}


def make_trio():
    return (MeshTrio().register("orders", ORDERS)
            .register("customers", CUSTOMERS))


@pytest.fixture(scope="module")
def trio():
    return make_trio()


def test_filter_join_group_sort(trio):
    st = check(
        trio,
        "SELECT c.region, SUM(o.amount) AS total, COUNT(*) AS cnt "
        "FROM orders o JOIN customers c ON o.cust = c.c_id "
        "WHERE o.amount > 100 GROUP BY c.region ORDER BY total DESC",
    )
    # integer SUM/COUNT ride the partial->all_to_all->final decomposition
    assert st["agg_partial_final"] >= 1, st


def test_filter_sort_limit(trio):
    check(
        trio,
        "SELECT o_id, amount FROM orders WHERE amount > 900 "
        "ORDER BY amount DESC, o_id LIMIT 17",
    )
    check(
        trio,
        "SELECT o_id FROM orders WHERE amount BETWEEN 10 AND 40 "
        "ORDER BY o_id LIMIT 10 OFFSET 5",
    )


def test_left_join_null_keys(trio):
    check(
        trio,
        "SELECT o.o_id, c.name FROM orders o "
        "LEFT JOIN customers c ON o.cust = c.c_id "
        "WHERE o.amount < 50 ORDER BY o.o_id",
    )


def test_right_and_full_join(trio):
    check(
        trio,
        "SELECT c.c_id, o.o_id FROM orders o "
        "RIGHT JOIN customers c ON o.cust = c.c_id "
        "WHERE c.region = 2 ORDER BY c.c_id, o.o_id",
    )
    check(
        trio,
        "SELECT c.c_id, o.o_id FROM orders o "
        "FULL JOIN customers c ON o.cust = c.c_id "
        "ORDER BY c.c_id NULLS FIRST, o.o_id LIMIT 50",
    )


def test_string_group_keys(trio):
    check(
        trio,
        "SELECT tag, COUNT(*) AS n, AVG(score) AS avg_s FROM orders "
        "GROUP BY tag ORDER BY tag",
        float_tol=1e-12,  # partial/final f64 sums reassociate
    )


def test_multi_key_group_and_sort(trio):
    check(
        trio,
        "SELECT cust, tag, SUM(amount) AS s FROM orders "
        "WHERE amount IS NOT NULL GROUP BY cust, tag "
        "ORDER BY cust NULLS LAST, tag",
    )


def test_global_aggregates(trio):
    check(
        trio,
        "SELECT COUNT(*), COUNT(amount), SUM(amount), MIN(amount), "
        "MAX(amount), AVG(amount) FROM orders",
    )
    check(trio, "SELECT MIN(tag), MAX(tag) FROM orders WHERE amount > 500")


def test_having_and_expressions(trio):
    check(
        trio,
        "SELECT cust, SUM(amount) AS s FROM orders GROUP BY cust "
        "HAVING SUM(amount) > 20000 ORDER BY s DESC",
    )
    check(
        trio,
        "SELECT o_id, amount * 2 + 1 AS a2 FROM orders "
        "WHERE amount % 7 = 3 AND tag = 'red' ORDER BY o_id",
    )


def test_distinct(trio):
    check(trio, "SELECT DISTINCT cust FROM orders ORDER BY cust NULLS LAST")
    check(trio, "SELECT DISTINCT tag, cust % 5 FROM orders", ordered=False)


def test_count_distinct_grouped(trio):
    # DISTINCT aggregates ride the row-exchange path (groups co-located)
    check(
        trio,
        "SELECT tag, COUNT(DISTINCT cust) AS u FROM orders "
        "GROUP BY tag ORDER BY tag",
    )


def test_scalar_subquery_filter(trio):
    check(
        trio,
        "SELECT o_id, amount FROM orders "
        "WHERE amount > (SELECT AVG(amount) + 400 FROM orders) "
        "ORDER BY o_id",
    )


def test_join_string_keys(trio):
    trio.register("tags", {
        "tag": ["red", "green", "blue", "cyan", "unknown"],
        "prio": [3, 1, 2, 0, 9],
    })
    check(
        trio,
        "SELECT t.prio, COUNT(*) AS n FROM orders o "
        "JOIN tags t ON o.tag = t.tag GROUP BY t.prio ORDER BY t.prio",
    )


def test_skewed_keys_overflow_retry(trio):
    """Every row shares one join key: the bounded exchange must overflow
    and `try_execute` grow and retry to the correct result."""
    trio.register("skew", {"k": [1] * 3000, "v": list(range(3000))})
    trio.register("dim", {"k": [1, 2], "w": [10, 20]})
    st = check(
        trio, "SELECT SUM(s.v + d.w) AS t FROM skew s JOIN dim d ON s.k = d.k"
    )
    assert st["overflow_retries"] >= 1, st


def test_unsupported_shapes_fall_back_correctly(trio):
    check(
        trio,
        "SELECT o_id, LAG(amount, 1) OVER (ORDER BY o_id) AS prev "
        "FROM orders WHERE amount > 990 ORDER BY o_id LIMIT 5",
        mesh_used=False,
    )
    check(
        trio,
        "SELECT o_id FROM (SELECT o_id FROM orders ORDER BY amount DESC "
        "LIMIT 100) sub WHERE o_id % 2 = 0 ORDER BY o_id",
        mesh_used=False,
    )


def test_empty_result(trio):
    check(trio, "SELECT o_id FROM orders WHERE amount > 100000 ORDER BY o_id")


def test_dml_invalidates_mesh_shards():
    fresh = make_trio()
    sql = ("SELECT cust, SUM(amount) AS s FROM orders GROUP BY cust "
           "ORDER BY cust NULLS LAST")
    check(fresh, sql)
    fresh.sql("INSERT INTO orders (o_id, cust, amount, tag, score) "
              "VALUES (99999, 3, 500, 'red', 1.0)")
    fresh.sql("DELETE FROM orders WHERE amount < 20")
    check(fresh, sql)


def test_program_reuse_across_calls(trio):
    sql = ("SELECT cust, COUNT(*) FROM orders WHERE amount > 500 "
           "GROUP BY cust ORDER BY cust NULLS LAST")
    check(trio, sql)
    st = check(trio, sql)
    assert st["compiles"] == 0 and st["hits"] >= 1, st


def test_env_mesh_enable(monkeypatch):
    """QE_MESH_DEVICES=8 turns a plain CPU Session into a mesh Session of
    8 CPU shards — the path every entry point (REPL/CLI/pgwire/Flight)
    inherits."""
    monkeypatch.setenv("QE_MESH_DEVICES", "8")
    s = Session(device="cpu")
    assert s.mesh_pipeline is not None and s.mesh_pipeline.n == 8
    assert all(d.type == "cpu" for d in s.mesh_pipeline.mesh.devices)
    s.register_table("t", {"k": [1, 2, 1, 2], "v": [10, 20, 30, 40]})
    r = s.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
    assert r.to_pylist() == [(1, 40), (2, 60)]
    assert s.mesh_pipeline.stats["compiles"] == 1
    monkeypatch.setenv("QE_MESH_DEVICES", "1")
    assert Session(device="cpu").mesh_pipeline is None


def test_mesh_of_another_device_kind_raises():
    with pytest.raises(ValueError, match="device kind"):
        Session(device="cpu", mesh=make_mesh(["meta"] * 2))


def test_explain_analyze_reports_the_mesh(trio):
    text = "\n".join(r[0] for r in trio.port.sql(
        "EXPLAIN ANALYZE SELECT cust, COUNT(*) FROM orders GROUP BY cust"
    ).to_pylist())
    assert "mesh: devices=8 compiles=" in text, text


def test_dynamic_literals_and_subplans_per_shard():
    """A query with a literal that is a program input and a scalar
    subquery, on 8 shards, twice: each shard's body reads its own literal
    and subquery batch (per thread), the rows are right on both runs (the
    second a cache hit with another literal), and afterwards no body's
    state is left on the evaluator."""
    fresh = make_trio()
    ev = fresh.port.executor.evaluator
    for bound in (100, 700):
        sql = ("SELECT cust, COUNT(*) AS n FROM orders "
               f"WHERE amount > {bound} "
               "AND amount < (SELECT MAX(amount) - 50 FROM orders) "
               "GROUP BY cust ORDER BY cust NULLS LAST")
        st = check(fresh, sql)
        assert ev._dyn_literals is None and ev._subplans is None
        assert ev._shard_device is None
    assert st["hits"] >= 1 and st["compiles"] == 0, st


@pytest.mark.slow
def test_partitioned_windows_on_mesh(trio):
    check(
        trio,
        "SELECT o_id, "
        "ROW_NUMBER() OVER (PARTITION BY cust ORDER BY amount, o_id) AS rn, "
        "SUM(amount) OVER (PARTITION BY cust ORDER BY amount, o_id) AS run "
        "FROM orders WHERE amount > 800 ORDER BY o_id",
    )
    check(
        trio,
        "SELECT o_id, "
        "RANK() OVER (PARTITION BY cust ORDER BY amount, o_id) AS r1, "
        "RANK() OVER (PARTITION BY tag ORDER BY amount, o_id) AS r2 "
        "FROM orders WHERE amount > 950 ORDER BY o_id",
        mesh_used=False,
    )


def test_set_ops_on_mesh(trio):
    check(
        trio,
        "SELECT cust FROM orders WHERE amount > 900 "
        "UNION ALL SELECT c_id FROM customers WHERE region = 1",
        ordered=False,
    )
    check(
        trio,
        "SELECT cust FROM orders WHERE amount > 500 "
        "UNION SELECT c_id FROM customers",
        ordered=False,
    )
    check(
        trio,
        "SELECT cust FROM orders WHERE amount > 200 "
        "INTERSECT SELECT c_id FROM customers WHERE region < 3",
        ordered=False,
    )
    check(
        trio,
        "SELECT c_id FROM customers "
        "EXCEPT SELECT cust FROM orders WHERE amount > 700",
        ordered=False,
    )


def test_unbounded_dup_join_count_emit_sync(trio):
    """A join where NEITHER side has a bounded key multiplicity runs on the
    mesh through the count->emit sync: a count program returns the max
    per-shard output size (spmd.pmax), then the emit program runs with that
    static capacity."""
    rng = np.random.default_rng(21)
    ta = {
        "k": rng.integers(0, 20, 600).tolist(),
        "va": rng.integers(0, 100, 600).tolist(),
    }
    tb = {
        "k": rng.integers(0, 20, 400).tolist(),
        "vb": rng.integers(0, 100, 400).tolist(),
    }
    for i in range(0, 600, 83):
        ta["k"][i] = None
    trio.register("ta", ta).register("tb", tb)
    sqls = [
        ("SELECT a.k, a.va, b.vb FROM ta a JOIN tb b ON a.k = b.k", False),
        ("SELECT a.k, COUNT(*) AS c, SUM(a.va + b.vb) AS s "
         "FROM ta a JOIN tb b ON a.k = b.k GROUP BY a.k ORDER BY a.k",
         True),
        ("SELECT a.k, a.va, b.vb FROM ta a LEFT JOIN tb b "
         "ON a.k = b.k WHERE a.va > 30", False),
    ]
    for sql, ordered in sqls:
        st = check(trio, sql, ordered=ordered)
        assert st["joins_counted"] >= 1, (sql, st)


def test_global_rank_windows_on_mesh(trio):
    sqls = [
        "SELECT o_id, ROW_NUMBER() OVER (ORDER BY amount DESC, o_id) AS rn "
        "FROM orders WHERE amount > 700 ORDER BY rn LIMIT 40",
        "SELECT o_id, RANK() OVER (ORDER BY cust) AS r, "
        "DENSE_RANK() OVER (ORDER BY cust) AS d "
        "FROM orders WHERE amount IS NOT NULL ORDER BY o_id LIMIT 60",
        "SELECT o_id, DENSE_RANK() OVER (ORDER BY cust DESC) AS d "
        "FROM orders ORDER BY o_id LIMIT 50",
        "SELECT o_id, ROW_NUMBER() OVER (ORDER BY amount, o_id) AS rn, "
        "RANK() OVER (ORDER BY amount) AS r, "
        "DENSE_RANK() OVER (ORDER BY amount) AS d "
        "FROM orders WHERE cust IS NOT NULL ORDER BY o_id LIMIT 60",
    ]
    for sql in sqls:
        check(trio, sql)
    check(
        trio,
        "SELECT COUNT(*) AS c, MAX(r) AS mx FROM ("
        "SELECT RANK() OVER (ORDER BY amount) AS r FROM orders "
        "WHERE amount IS NOT NULL) sub",
    )


@pytest.mark.slow
def test_global_aggregate_windows_on_mesh(trio):
    check(
        trio,
        "SELECT o_id, SUM(amount) OVER (ORDER BY cust) AS rs, "
        "COUNT(amount) OVER (ORDER BY cust) AS rc, "
        "MIN(amount) OVER (ORDER BY cust) AS rmin, "
        "MAX(amount) OVER (ORDER BY cust) AS rmax "
        "FROM orders ORDER BY o_id LIMIT 80",
    )
    check(
        trio,
        "SELECT o_id, SUM(amount) OVER () AS s, COUNT(*) OVER () AS c, "
        "MIN(amount) OVER () AS lo, MAX(amount) OVER () AS hi "
        "FROM orders WHERE cust = 7 ORDER BY o_id",
    )
    check(
        trio,
        "SELECT o_id, AVG(score) OVER () AS a FROM orders "
        "WHERE cust = 3 ORDER BY o_id",
        float_tol=1e-12,
    )
    check(
        trio,
        "SELECT o_id, RANK() OVER (ORDER BY amount) AS r, "
        "SUM(amount) OVER (ORDER BY amount) AS rs "
        "FROM orders WHERE amount IS NOT NULL AND cust < 10 "
        "ORDER BY o_id",
    )
    check(
        trio,
        "SELECT o_id, SUM(amount) OVER (ORDER BY o_id) AS rs "
        "FROM orders WHERE cust = 11 OR amount IS NULL "
        "ORDER BY o_id LIMIT 60",
    )


@pytest.mark.slow
def test_global_lag_lead_on_mesh(trio):
    sqls = [
        "SELECT o_id, LAG(amount) OVER (ORDER BY o_id) AS lg, "
        "LEAD(amount) OVER (ORDER BY o_id) AS ld "
        "FROM orders ORDER BY o_id LIMIT 60",
        "SELECT o_id, LAG(amount, 3) OVER (ORDER BY cust, o_id) AS lg3, "
        "LEAD(amount, 2, -1) OVER (ORDER BY cust, o_id) AS ld2 "
        "FROM orders WHERE amount IS NOT NULL ORDER BY o_id LIMIT 80",
        "SELECT o_id, LAG(amount) OVER (ORDER BY cust) AS lg "
        "FROM orders ORDER BY o_id LIMIT 80",
        "SELECT o_id, LAG(cust) OVER (ORDER BY amount DESC, o_id) AS lg "
        "FROM orders ORDER BY o_id LIMIT 60",
        "SELECT o_id, LAG(tag) OVER (ORDER BY o_id) AS lt "
        "FROM orders WHERE cust < 20 ORDER BY o_id LIMIT 50",
    ]
    for sql in sqls:
        check(trio, sql)


@pytest.mark.slow
def test_global_rows_frames_on_mesh(trio):
    sqls = [
        "SELECT o_id, SUM(amount) OVER (ORDER BY o_id "
        "ROWS BETWEEN 3 PRECEDING AND CURRENT ROW) AS s3 "
        "FROM orders ORDER BY o_id LIMIT 80",
        "SELECT o_id, MIN(amount) OVER (ORDER BY o_id "
        "ROWS BETWEEN 2 PRECEDING AND 4 FOLLOWING) AS lo, "
        "MAX(amount) OVER (ORDER BY o_id "
        "ROWS BETWEEN 2 PRECEDING AND 4 FOLLOWING) AS hi, "
        "COUNT(amount) OVER (ORDER BY o_id "
        "ROWS BETWEEN 2 PRECEDING AND 4 FOLLOWING) AS c "
        "FROM orders ORDER BY o_id LIMIT 80",
        "SELECT o_id, SUM(amount) OVER (ORDER BY o_id "
        "ROWS BETWEEN UNBOUNDED PRECEDING AND 2 FOLLOWING) AS s "
        "FROM orders WHERE cust < 30 ORDER BY o_id LIMIT 80",
        "SELECT o_id, MAX(amount) OVER (ORDER BY o_id "
        "ROWS BETWEEN 1 PRECEDING AND UNBOUNDED FOLLOWING) AS m "
        "FROM orders WHERE cust < 30 ORDER BY o_id LIMIT 80",
        "SELECT o_id, SUM(amount) OVER (ORDER BY cust "
        "ROWS BETWEEN 5 PRECEDING AND CURRENT ROW) AS s "
        "FROM orders ORDER BY o_id LIMIT 80",
    ]
    for sql in sqls:
        check(trio, sql)


@pytest.mark.slow
def test_global_ntile_first_last_on_mesh(trio):
    sqls = [
        "SELECT o_id, NTILE(7) OVER (ORDER BY cust) AS t "
        "FROM orders ORDER BY o_id LIMIT 80",
        "SELECT o_id, NTILE(13) OVER (ORDER BY amount, o_id) AS t "
        "FROM orders WHERE amount IS NOT NULL ORDER BY o_id LIMIT 80",
        "SELECT o_id, FIRST_VALUE(amount) OVER (ORDER BY cust, o_id) AS f "
        "FROM orders ORDER BY o_id LIMIT 60",
        "SELECT o_id, LAST_VALUE(amount) OVER (ORDER BY cust) AS lp, "
        "LAST_VALUE(amount) OVER (ORDER BY cust ROWS BETWEEN UNBOUNDED "
        "PRECEDING AND UNBOUNDED FOLLOWING) AS lg "
        "FROM orders ORDER BY o_id LIMIT 60",
    ]
    for sql in sqls:
        check(trio, sql)


def test_order_sensitive_window_fallback(trio):
    check(
        trio,
        "SELECT s.o_id, LAG(s.amount) OVER (ORDER BY s.o_id) AS lg FROM ("
        "SELECT o.o_id AS o_id, o.amount AS amount FROM orders o "
        "JOIN customers c ON o.cust = c.c_id) s ORDER BY s.o_id LIMIT 60",
        mesh_used=False,
    )


def test_distributed_executor_over_the_mesh():
    """DistributedExecutor(mesh=...) runs a plan that lowers as one program
    over the mesh (its own executor on the coordinator's device), and the
    stage walk still runs the others."""
    from query_engine_tpu_torch.parallel.coordinator import Coordinator
    from query_engine_tpu_torch.parallel.dexecutor import DistributedExecutor
    from query_engine_tpu_torch.sql.parser import parse_sql

    s = Session(device="cpu")
    s.register_table("orders", ORDERS)
    s.register_table("customers", CUSTOMERS)
    c = Coordinator(device="cpu")
    for i in range(4):
        c.register_worker(f"w{i}")
    dx = DistributedExecutor(c, mesh=port_mesh())
    sql = ("SELECT c.region, SUM(o.amount) AS total FROM orders o "
           "JOIN customers c ON o.cust = c.c_id GROUP BY c.region "
           "ORDER BY c.region")
    plan = s.optimizer.optimize(s.planner.create_logical_plan(parse_sql(sql)))
    got = dx.execute(plan, s.sources).to_pylist()
    same_rows(got, _jax_rows(sql), sql=sql)
    mp = dx._mesh_pipeline
    assert mp.stats["compiles"] == 1 and dx.last_stages == [], mp.stats
    assert mp.executor.device.type == "cpu"


def _jax_rows(sql):
    js = JSession()
    js.register_table("orders", ORDERS)
    js.register_table("customers", CUSTOMERS)
    return js.sql(sql).to_pylist()
