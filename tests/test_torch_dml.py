"""DML on the port's Session against the JAX Session, statement by
statement, in the three modes of `torch_session_diff`: the cases of
tests/test_insert_select.py, tests/test_dml_from.py, the DML cases of
tests/test_e2e_queries.py and tests/test_decimal.py, and the reference's
encoding rules the port reproduces on the device: an integer column
truncates a float, NULL assignments, SERIAL through INSERT ... SELECT,
RETURNING, a string column's dictionary rebuilt from the values present
after UPDATE and INSERT (ORDER BY, MIN/MAX, GROUP BY and a join over it),
a DECIMAL expression assigned by UPDATE scaled twice, and DELETE ... WHERE
k IN (SELECT ...) raising in both packages (ROADMAP §3). Then the steps of
tests/test_edge_cases.py::test_dml_interleaved_with_cached_programs:
compiled against eager against JAX. And where the port goes past the
reference: INSERT ... SELECT and UPDATE on a table with a DATE column,
which raise TypeError in the JAX package, give the rows a numpy edit of
the table gives.
"""

import datetime

import pytest

from torch_session_diff import MODES, outcome, port_session, run_script, same

from query_engine_tpu.engine.session import Session as JSession


def _src(s):
    s.register_table("src", {
        "k": [1, 2, 3, 4], "x": [10.5, 20.5, 30.5, 40.5],
        "nm": ["a", "b", "c", "d"],
    })
    s.sql("CREATE TABLE dst (k INT, x DOUBLE PRECISION, nm TEXT)")


def _emp(s):
    s.sql("CREATE TABLE emp (id INT, dept INT, salary INT)")
    s.sql("INSERT INTO emp VALUES (1, 10, 100), (2, 10, 200), (3, 20, 300)")
    s.sql("CREATE TABLE raises (dept INT, pct INT)")
    s.sql("INSERT INTO raises VALUES (10, 50)")


def _prices(s):
    s.sql("CREATE TABLE p (name TEXT, price DECIMAL(10, 2), qty INT)")
    s.sql("INSERT INTO p VALUES ('a', 19.99, 3), ('b', 5.50, 2), "
          "('c', 0.01, 100), ('d', NULL, 1)")


def _words(s):
    s.register_table("w", {
        "id": [1, 2, 3, 4, 5, 6],
        "s": ["pear", "apple", None, "fig", "apple", "kiwi"],
        "v": [1.5, 2.5, 3.5, 4.5, 5.5, 6.5],
    })
    s.register_table("d", {"s": ["apple", "banana", "fig", "zucchini"],
                           "n": [1, 2, 3, 4]})


STRING_READS = [
    "SELECT id, s FROM w WHERE s > 'banana' OR s IS NULL "
    "ORDER BY s NULLS FIRST, id",
    "SELECT s, COUNT(*), SUM(v), MIN(s), MAX(s) FROM w GROUP BY s "
    "ORDER BY s",
    "SELECT w.id, d.n FROM w JOIN d ON w.s = d.s ORDER BY w.id",
]

CASES = {
    # tests/test_insert_select.py
    "insert_select_basic": (_src, [
        "INSERT INTO dst SELECT k, x, nm FROM src WHERE k > 1",
        "SELECT k FROM dst ORDER BY k",
        "SELECT * FROM dst ORDER BY k",
    ]),
    "insert_select_expressions_and_columns": (_src, [
        "INSERT INTO dst (k, x, nm) "
        "SELECT k * 10, x, UPPER(nm) FROM src WHERE k = 1",
        "SELECT k, nm FROM dst ORDER BY k",
    ]),
    "insert_select_with_body": (_src, [
        "CREATE TABLE agg (g INT, total DOUBLE PRECISION)",
        "INSERT INTO agg WITH t AS (SELECT k % 2 AS g, x FROM src) "
        "SELECT g, SUM(x) FROM t GROUP BY g",
        "SELECT * FROM agg ORDER BY g",
    ]),
    "insert_select_on_conflict": (_src, [
        "CREATE TABLE u (k INT, v INT)",
        "INSERT INTO u VALUES (2, 0), (9, 9)",
        "INSERT INTO u SELECT k, k FROM src "
        "ON CONFLICT (k) DO UPDATE SET v = 100",
        "SELECT * FROM u ORDER BY k",
    ]),
    "insert_select_column_count_mismatch": (_src, [
        "INSERT INTO dst SELECT k FROM src",
    ]),
    "insert_select_partial_columns_null_fill": (_src, [
        "INSERT INTO dst (nm, k) SELECT nm, k FROM src WHERE k < 3",
        "SELECT * FROM dst ORDER BY k",
    ]),
    # tests/test_dml_from.py
    "update_from": (_emp, [
        "UPDATE emp SET salary = emp.salary + emp.salary * r.pct / 100 "
        "FROM raises r WHERE emp.dept = r.dept",
        "SELECT id, salary FROM emp ORDER BY id",
    ]),
    "update_from_no_match": (_emp, [
        "UPDATE emp SET salary = 0 FROM raises r WHERE emp.dept = 999",
        "SELECT * FROM emp ORDER BY id",
    ]),
    "update_from_returning": (_emp, [
        "UPDATE emp SET salary = 0 FROM raises r "
        "WHERE emp.dept = r.dept RETURNING id, salary",
    ]),
    "delete_using": (_emp, [
        "DELETE FROM emp USING raises r WHERE emp.dept = r.dept",
        "SELECT id FROM emp",
    ]),
    "delete_using_subquery": (_emp, [
        "DELETE FROM emp USING (SELECT 20 AS d) x WHERE emp.dept = x.d",
        "SELECT id FROM emp ORDER BY id",
    ]),
    "update_from_first_match_wins": (_emp, [
        "INSERT INTO raises VALUES (10, 900)",
        "UPDATE emp SET salary = r.pct FROM raises r "
        "WHERE emp.dept = r.dept",
        "SELECT id, salary FROM emp ORDER BY id",
    ]),
    "delete_using_returning": (_emp, [
        "DELETE FROM emp USING raises r WHERE emp.dept = r.dept "
        "RETURNING id, salary",
        "SELECT * FROM emp",
    ]),
    # tests/test_e2e_queries.py:329-360
    "create_insert_update_delete": (None, [
        "CREATE TABLE t (id INT, name TEXT)",
        "INSERT INTO t (id, name) VALUES (1, 'a'), (2, 'b'), (3, 'c')",
        "SELECT * FROM t ORDER BY id",
        "UPDATE t SET name = 'z' WHERE id = 2",
        "SELECT name FROM t WHERE id = 2",
        "DELETE FROM t WHERE id = 1",
        "SELECT COUNT(*) FROM t",
    ]),
    "upsert_on_conflict": (None, [
        "CREATE TABLE u (id INT, v TEXT)",
        "INSERT INTO u (id, v) VALUES (1, 'x')",
        "INSERT INTO u (id, v) VALUES (1, 'y') "
        "ON CONFLICT (id) DO UPDATE SET v = 'y'",
        "SELECT * FROM u",
        "INSERT INTO u (id, v) VALUES (1, 'z') ON CONFLICT (id) DO NOTHING",
        "SELECT * FROM u",
    ]),
    "upsert_mixed_returning_and_null_keys": (None, [
        "CREATE TABLE u (id INT, v TEXT, w DOUBLE PRECISION)",
        "INSERT INTO u VALUES (1, 'x', 1.0), (NULL, 'n', 2.0), (3, 'c', 3.0)"
        ", (1, 'dup', 4.0)",
        "INSERT INTO u VALUES (1, 'y', 9.0), (NULL, 'm', 9.0), (7, 'q', 9.0)"
        ", (7, 'r', 9.0) ON CONFLICT (id) DO UPDATE SET w = 0.5 RETURNING *",
        "SELECT * FROM u ORDER BY id NULLS FIRST, v",
        "INSERT INTO u VALUES (3, 'k', 1.0), (8, 'e', 2.0) "
        "ON CONFLICT (id, v) DO NOTHING RETURNING id",
        "SELECT v, COUNT(*) FROM u GROUP BY v ORDER BY v",
    ]),
    "insert_returning": (None, [
        "CREATE TABLE r (id INT, v TEXT)",
        "INSERT INTO r (id, v) VALUES (7, 'q') RETURNING id, v",
        "INSERT INTO r VALUES (8, NULL), (9, 'z') RETURNING *",
    ]),
    "index_accelerated_lookup": (None, [
        "CREATE TABLE idx_t (id INT, v INT)",
        "INSERT INTO idx_t (id, v) VALUES (1, 10), (2, 20), (3, 30)",
        "CREATE INDEX idx_id ON idx_t (id)",
        "SELECT v FROM idx_t WHERE id = 2",
        "DROP INDEX idx_id",
        "DROP INDEX idx_id",
        "DROP INDEX IF EXISTS idx_id",
    ]),
    # tests/test_decimal.py
    "decimal_storage_and_arith": (_prices, [
        "SELECT price FROM p ORDER BY name",
        "SELECT name, price * qty FROM p ORDER BY name",
        "SELECT price + price, price * price, price - 0.01 FROM p "
        "WHERE name = 'a'",
        "SELECT SUM(price), AVG(price), MIN(price), MAX(price), "
        "COUNT(price) FROM p",
    ]),
    "decimal_compare_divide_cast": (_prices, [
        "SELECT name FROM p WHERE price > 5.5 ORDER BY name",
        "SELECT name FROM p WHERE price = 5.5",
        "SELECT name FROM p WHERE price >= 1",
        "SELECT price / 2, price / qty FROM p WHERE name = 'b'",
        "SELECT CAST(price AS DOUBLE), CAST(price AS INT), "
        "CAST(qty AS DECIMAL(8, 3)) FROM p WHERE name = 'a'",
        "SELECT ROUND(price) FROM p WHERE name = 'b'",
        "SELECT price, COUNT(*) FROM p GROUP BY price ORDER BY price",
        "SELECT name, price * qty AS total FROM p "
        "WHERE price > 1 ORDER BY total DESC",
    ]),
    "decimal_update_and_insert_select": (_prices, [
        # a DECIMAL expression assigned by UPDATE is stored scaled twice
        # by the reference (ROADMAP §3); a float one is exact
        "UPDATE p SET price = price + 1 WHERE name = 'a'",
        "UPDATE p SET price = qty * 1.5 WHERE name = 'b'",
        "SELECT * FROM p ORDER BY name",
        "CREATE TABLE q (v DECIMAL(10, 1), w DOUBLE PRECISION)",
        "INSERT INTO q SELECT price, price FROM p",
        "SELECT * FROM q ORDER BY w NULLS LAST",
    ]),
    # the encoding rules
    "int_column_truncates_float": (None, [
        "CREATE TABLE x (i INT, b BIGINT, f DOUBLE PRECISION, o BOOLEAN)",
        "INSERT INTO x VALUES (20, 7, 1.0, true), (30, -7, 2.0, false), "
        "(-5, 3, 3.0, NULL)",
        "UPDATE x SET i = i * 1.5, b = b / 2.0, f = i, o = f > 1.5",
        "SELECT * FROM x ORDER BY f",
        "INSERT INTO x SELECT f * 2.75, f * -1.5, i, o FROM x",
        "SELECT * FROM x ORDER BY f, i",
    ]),
    "null_assignments": (_words, [
        "UPDATE w SET s = NULL, v = NULL WHERE id >= 5",
        "SELECT * FROM w ORDER BY id",
        "UPDATE w SET s = 'apple' WHERE s IS NULL",
        *STRING_READS,
    ]),
    "string_dictionary_after_update": (_words, [
        "UPDATE w SET s = 'banana' WHERE id = 1",
        *STRING_READS,
        "UPDATE w SET s = UPPER(s) || 'x' WHERE id > 3",
        *STRING_READS,
    ]),
    "string_dictionary_after_insert": (_words, [
        "INSERT INTO w VALUES (7, 'aardvark', 0.5), (8, 'zucchini', 8.5), "
        "(9, NULL, 9.5)",
        *STRING_READS,
        "INSERT INTO w SELECT n + 100, s, n * 1.0 FROM d WHERE n > 1",
        "DELETE FROM w WHERE s < 'c'",
        *STRING_READS,
    ]),
    "serial_insert_select": (_src, [
        "CREATE TABLE sq (id SERIAL, nm TEXT)",
        "INSERT INTO sq (nm) SELECT nm FROM src WHERE k < 3",
        "INSERT INTO sq SELECT k * 10, nm FROM src WHERE k = 3",
        "INSERT INTO sq (nm) SELECT nm FROM src WHERE k = 4",
        "INSERT INTO sq (nm) VALUES ('z')",
        "SELECT * FROM sq ORDER BY id",
    ]),
    "update_delete_returning": (_words, [
        "UPDATE w SET v = v * 2 WHERE id < 3 RETURNING id, v",
        "UPDATE w SET s = 'pear' WHERE id = 4 RETURNING *",
        "DELETE FROM w WHERE v > 6 RETURNING s, id",
        "DELETE FROM w WHERE id = 42 RETURNING id",
        "UPDATE w SET v = 0 WHERE id = 2 RETURNING id + 1",
        "SELECT * FROM w ORDER BY id",
    ]),
    "delete_everything_then_insert": (_words, [
        "DELETE FROM w",
        "SELECT COUNT(*), MIN(s) FROM w",
        "INSERT INTO w VALUES (1, 'b', 1.0)",
        "SELECT * FROM w",
    ]),
    "dml_subquery_in_where_raises_in_both": (_words, [
        # the reference hands a logical subplan to its executor (ROADMAP §3)
        "DELETE FROM w WHERE s IN (SELECT s FROM d)",
        "UPDATE w SET v = 0 WHERE id IN (SELECT n FROM d)",
        "SELECT COUNT(*) FROM w",
    ]),
    "string_values_into_other_columns": (_prices, [
        # numpy's conversion of the stored rows' strings: '7.5' is stored,
        # 'x' raises ValueError only where a stored row holds it
        "INSERT INTO p VALUES ('q', '7.5', '3')",
        "CREATE TABLE s (t TEXT, n INT)",
        "INSERT INTO s VALUES ('5', 1), ('x', 2), (NULL, 3)",
        "UPDATE s SET n = t WHERE n = 1",
        "UPDATE s SET n = t",
        "INSERT INTO p (name, qty) SELECT t, t FROM s WHERE n <> 2",
        "SELECT * FROM p ORDER BY name",
        "SELECT * FROM s ORDER BY n",
    ]),
    "dml_errors": (_words, [
        "UPDATE w SET nope = 1",
        "UPDATE nope SET v = 1",
        "DELETE FROM nope",
        "INSERT INTO nope VALUES (1)",
        "INSERT INTO w VALUES (1, 'a')",
        "INSERT INTO w (id, zz) VALUES (1, 2)",
        "INSERT INTO w VALUES (1 + 1, 'a', 1.0)",
        "UPDATE w SET v = 1 RETURNING v * 2",
    ]),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_dml_matches_jax(case, mode):
    setup, script = CASES[case]
    run_script(script, mode, setup)


def test_in_subquery_delete_error_type():
    """Both packages raise ExecutionError ("cannot execute Projection")."""
    _, _, outs = run_script(["DELETE FROM w WHERE s IN (SELECT s FROM d)"],
                            "compiled", _words)
    assert outs == [("error", "ExecutionError")]


EDGE_QUERIES = [
    "SELECT k, COUNT(*), SUM(v) FROM t GROUP BY k ORDER BY k",
    "SELECT t.v, d.w FROM t JOIN d ON t.k = d.k ORDER BY t.v",
    "SELECT MIN(v), MAX(v) FROM t",
]
EDGE_STEPS = [
    "INSERT INTO t VALUES (1, 10), (2, 20), (1, 30)",
    "INSERT INTO t VALUES (3, 40), (9, 50)",   # widens k bounds
    "UPDATE t SET v = v + 1 WHERE k = 1",
    "DELETE FROM t WHERE k = 9",
    "INSERT INTO t VALUES (2, 60), (2, 70), (2, 80)",  # raises k dup
    "INSERT INTO d VALUES (1, 101)",  # d.k no longer unique
]


def test_dml_interleaved_with_cached_programs():
    """Bounds, key multiplicities and compiled programs are cached per
    table version; DML must drop them. The steps of the JAX edge-case test
    through the port compiled, the port eager and the JAX Session."""

    def fresh(s):
        s.sql("CREATE TABLE t (k INT, v INT)")
        s.sql("CREATE TABLE d (k INT, w INT)")
        s.sql("INSERT INTO d VALUES (1, 100), (2, 200), (3, 300)")
        return s

    js = fresh(JSession())
    compiled = fresh(port_session("compiled"))
    eager = fresh(port_session("QE_COMPILED=0"))
    for step in EDGE_STEPS:
        for s in (js, compiled, eager):
            s.sql(step)
        for q in EDGE_QUERIES:
            want = outcome(js, q)
            assert same(outcome(compiled, q), want), (step, q)
            assert same(outcome(eager, q), want), (step, q)
    assert compiled.executor.pipeline.stats["compiles"] > 0


DATED = {
    "id": [1, 2, 3, 4],
    "d": [datetime.date(1995, 1, 2), datetime.date(1996, 3, 4), None,
          datetime.date(1992, 12, 31)],
    "x": [1.5, 2.5, 3.5, 4.5],
}


def _dated(pkg):
    """DATED as a batch of package `pkg` with a DATE32 column (days since
    1970-01-01)."""
    import importlib

    batch_cls = importlib.import_module(f"{pkg}.columnar.batch").ColumnBatch
    schema_mod = importlib.import_module(f"{pkg}.core.schema")
    DataType = importlib.import_module(f"{pkg}.core.types").DataType
    Field, Schema = schema_mod.Field, schema_mod.Schema
    epoch = datetime.date(1970, 1, 1)
    days = [None if d is None else (d - epoch).days for d in DATED["d"]]
    schema = Schema([Field("id", DataType.int64()),
                     Field("d", DataType.date32()),
                     Field("x", DataType.float64())])
    return batch_cls.from_pydict({"id": DATED["id"], "d": days,
                                  "x": DATED["x"]}, schema)


@pytest.mark.parametrize("mode", MODES)
def test_date_tables_where_the_reference_raises(mode):
    """INSERT ... SELECT and UPDATE on a table with a DATE column raise
    TypeError in the JAX package (its host rows hold datetime.date, which
    its int32 encoder rejects); the port keeps the plane and gives the
    rows a plain edit of the table gives. INSERT takes DATE '...'."""
    js = JSession()
    js.register_table("t", _dated("query_engine_tpu"))
    with pytest.raises(TypeError):
        js.sql("UPDATE t SET x = x * 2 WHERE id = 1")
    js.sql("CREATE TABLE u AS SELECT * FROM t")
    with pytest.raises(TypeError):
        js.sql("INSERT INTO u SELECT * FROM t")

    s = port_session(mode)
    s.register_table("t", _dated("query_engine_tpu_torch"))
    assert s.sql("UPDATE t SET x = x * 2 WHERE id = 1").to_pylist() == \
        [("UPDATE 1",)]
    s.sql("CREATE TABLE u AS SELECT * FROM t")
    assert s.sql("INSERT INTO u SELECT * FROM t WHERE d IS NOT NULL"
                 ).to_pylist() == [("INSERT 0 3",)]
    s.sql("INSERT INTO u VALUES (5, DATE '2001-02-03', 0.5), "
          "(6, '1970-01-02', 0.25)")
    want = [(i, d, x * 2 if i == 1 else x)
            for i, d, x in zip(DATED["id"], DATED["d"], DATED["x"])]
    want = want + [r for r in want if r[1] is not None] + [
        (5, datetime.date(2001, 2, 3), 0.5),
        (6, datetime.date(1970, 1, 2), 0.25)]
    got = s.sql("SELECT * FROM u ORDER BY id, d").to_pylist()
    assert got == sorted(want, key=lambda r: (r[0], r[1] or
                                              datetime.date.min))
    gone = sum(r[1] is not None and r[1] < datetime.date(1995, 6, 1)
               for r in want)
    assert s.sql("DELETE FROM u WHERE d < DATE '1995-06-01'").to_pylist() \
        == [(f"DELETE {gone}",)]
    assert s.sql("SELECT COUNT(*) FROM u").to_pylist() == \
        [(len(want) - gone,)]
