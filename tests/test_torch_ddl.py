"""DDL on the port's Session against the JAX Session, statement by
statement: the cases of tests/test_ctas.py (CREATE TABLE AS, TRUNCATE),
tests/test_alter_table.py (ADD/DROP/RENAME COLUMN, RENAME TO, SERIAL) and
tests/test_views.py (CREATE [OR REPLACE]/DROP VIEW, DROP TABLE), each in
the three modes of `torch_session_diff` (compiled, QE_COMPILED=0, the CUDA
admission of nodes). Statuses, rows in order and error types must be
equal; `tables()`, `views()` and `table_schema()` too.
"""

import pytest

from torch_session_diff import MODES, run_script


def _src(s):
    s.register_table("src", {
        "k": [1, 1, 2, 2], "x": [10, 20, 30, 40],
        "nm": ["a", "b", "c", "d"],
    })


def _t(s):
    s.register_table("t", {"k": [1, 1, 2, 2], "x": [10, 20, 30, 40]})


ALTER_SETUP = ["CREATE TABLE t (a INT, b TEXT)",
               "INSERT INTO t VALUES (1, 'x'), (2, 'y')"]

CASES = {
    # tests/test_ctas.py
    "ctas_aggregate": (_src, [
        "CREATE TABLE t2 AS SELECT k, SUM(x) AS total FROM src GROUP BY k",
        "SELECT * FROM t2 ORDER BY k",
    ]),
    "ctas_real_table": (_src, [
        "CREATE TABLE t2 AS SELECT k, x FROM src",
        "INSERT INTO t2 VALUES (9, 99)",
        "UPDATE t2 SET x = 0 WHERE k = 9",
        "SELECT x FROM t2 WHERE k = 9",
        "SELECT * FROM t2 ORDER BY k, x",
    ]),
    "ctas_body_and_strings": (_src, [
        "CREATE TABLE t3 AS WITH f AS (SELECT nm FROM src WHERE nm != 'a') "
        "SELECT nm FROM f",
        "SELECT nm FROM t3 ORDER BY nm",
    ]),
    "ctas_duplicate": (_src, [
        "CREATE TABLE t2 AS SELECT 1 AS a",
        "CREATE TABLE IF NOT EXISTS t2 AS SELECT 2 AS a",
        "SELECT a FROM t2",
        "CREATE TABLE t2 AS SELECT 3 AS a",
    ]),
    "truncate": (_src, [
        "CREATE TABLE tt (a INT)",
        "INSERT INTO tt VALUES (1), (2)",
        "TRUNCATE TABLE tt",
        "SELECT COUNT(*) FROM tt",
        "INSERT INTO tt VALUES (9)",
        "SELECT a FROM tt",
    ]),
    # tests/test_alter_table.py
    "add_column_then_update": (None, ALTER_SETUP + [
        "ALTER TABLE t ADD COLUMN c DOUBLE PRECISION",
        "SELECT * FROM t ORDER BY a",
        "UPDATE t SET c = a * 1.5",
        "SELECT c FROM t ORDER BY a",
    ]),
    "add_not_null_rejected": (None, ALTER_SETUP + [
        "ALTER TABLE t ADD COLUMN c INT NOT NULL",
    ]),
    "drop_column": (None, ALTER_SETUP + [
        "ALTER TABLE t DROP COLUMN b",
        "SELECT * FROM t ORDER BY a",
    ]),
    "drop_column_with_index": (None, ALTER_SETUP + [
        "CREATE INDEX ib ON t (b)",
        "ALTER TABLE t DROP COLUMN b",
        "INSERT INTO t VALUES (3)",
        "SELECT COUNT(*) FROM t",
    ]),
    "rename_column": (None, ALTER_SETUP + [
        "ALTER TABLE t RENAME COLUMN b TO label",
        "SELECT label FROM t WHERE label = 'x'",
        "SELECT * FROM t ORDER BY a",
    ]),
    "rename_table": (None, ALTER_SETUP + [
        "ALTER TABLE t RENAME TO t2",
        "SELECT COUNT(*) FROM t2",
        "SELECT * FROM t",
    ]),
    "duplicate_add_rejected": (None, ALTER_SETUP + [
        "ALTER TABLE t ADD COLUMN a INT",
    ]),
    "add_string_column_then_insert": (None, ALTER_SETUP + [
        "ALTER TABLE t ADD COLUMN note VARCHAR",
        "INSERT INTO t VALUES (3, 'z', 'n1')",
        "SELECT * FROM t ORDER BY a",
        "SELECT note, COUNT(*) FROM t GROUP BY note ORDER BY note",
    ]),
    "serial_fills_and_advances": (None, [
        "CREATE TABLE sq (id SERIAL, nm TEXT)",
        "INSERT INTO sq (nm) VALUES ('a'), ('b')",
        "SELECT id FROM sq ORDER BY id",
        "INSERT INTO sq VALUES (10, 'x')",
        "INSERT INTO sq (nm) VALUES ('c')",
        "SELECT id, nm FROM sq ORDER BY id",
    ]),
    "bigserial_with_returning": (None, [
        "CREATE TABLE bq (id BIGSERIAL, v INT)",
        "INSERT INTO bq (v) VALUES (7) RETURNING id, v",
    ]),
    # tests/test_views.py
    "view_create_and_query": (_t, [
        "CREATE VIEW v AS SELECT k, SUM(x) AS s FROM t GROUP BY k",
        "SELECT * FROM v ORDER BY k",
    ]),
    "view_twice_shares_materialization": (_t, [
        "CREATE VIEW v AS SELECT k, SUM(x) AS s FROM t GROUP BY k",
        "SELECT a.k FROM v a JOIN v b ON a.k = b.k "
        "WHERE a.s = (SELECT MAX(s) FROM v) ORDER BY a.k",
    ]),
    "view_or_replace": (_t, [
        "CREATE VIEW v AS SELECT k FROM t",
        "CREATE OR REPLACE VIEW v AS SELECT x FROM t WHERE x > 25",
        "SELECT COUNT(*) FROM v",
    ]),
    "view_column_rename_list": (_t, [
        "CREATE VIEW w(a, b) AS SELECT k, x FROM t",
        "SELECT a, b FROM w ORDER BY b DESC LIMIT 1",
    ]),
    "view_sees_dml": (_t, [
        "CREATE TABLE u (a INT)",
        "CREATE VIEW uv AS SELECT SUM(a) AS s FROM u",
        "INSERT INTO u VALUES (5), (6)",
        "SELECT s FROM uv",
    ]),
    "view_duplicate_rejected": (_t, [
        "CREATE VIEW v AS SELECT 1",
        "CREATE VIEW v AS SELECT 2",
    ]),
    "view_named_like_table_rejected": (_t, ["CREATE VIEW t AS SELECT 1"]),
    "view_column_count_mismatch": (_t, [
        "CREATE VIEW w(a) AS SELECT k, x FROM t",
    ]),
    "drop_view": (_t, [
        "CREATE VIEW v AS SELECT k FROM t",
        "DROP VIEW v",
        "SELECT * FROM v",
        "DROP VIEW IF EXISTS v",
        "DROP VIEW v",
    ]),
    "drop_table": (_t, [
        "CREATE TABLE tmp (a INT)",
        "INSERT INTO tmp VALUES (7)",
        "DROP TABLE tmp",
        "SELECT * FROM tmp",
        "DROP TABLE IF EXISTS tmp",
        "DROP TABLE tmp",
    ]),
    "view_with_cte_body": (_t, [
        "CREATE VIEW v AS WITH big AS (SELECT x FROM t WHERE x > 15) "
        "SELECT COUNT(*) AS c FROM big",
        "SELECT c FROM v",
    ]),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_ddl_matches_jax(case, mode):
    setup, script = CASES[case]
    js, ts, _ = run_script(script, mode, setup)
    assert ts.tables() == js.tables()
    assert ts.views() == js.views()
    for name in ts.tables() + ts.views():
        assert ts.table_schema(name).names() == js.table_schema(name).names()
        assert [str(f.data_type) for f in ts.table_schema(name)] == \
            [str(f.data_type) for f in js.table_schema(name)]


def test_create_table_then_insert_stays_on_the_session_device():
    """The empty batch of a CREATE TABLE is made on the Session's device,
    so the first INSERT concatenates planes of one device."""
    from torch_session_diff import port_session

    s = port_session("compiled")
    s.sql("CREATE TABLE e (a INT, b TEXT)")
    assert all(c.data.device == s.device
               for c in s.sources["e"].scan().columns)
    s.sql("INSERT INTO e VALUES (1, 'x')")
    assert s.sql("SELECT * FROM e").to_pylist() == [(1, "x")]


def test_explain_of_a_statement_names_its_type():
    from torch_session_diff import port_session

    from query_engine_tpu.engine.session import Session as JSession

    for stmt in ("CREATE TABLE z (a INT)", "DROP VIEW v",
                 "INSERT INTO z VALUES (1)", "BEGIN"):
        assert port_session("compiled").explain(stmt) == \
            JSession().explain(stmt)
