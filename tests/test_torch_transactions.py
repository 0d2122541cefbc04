"""BEGIN / COMMIT / ROLLBACK / SAVEPOINT on the port's Session against the
JAX Session: the 16 cases of tests/test_transactions.py, statement by
statement in the three modes of `torch_session_diff` (statuses, rows and
error types equal, PG's aborted-transaction state included), plus the
index and table-list checks those cases make on both Sessions' state, and
that ROLLBACK restores the very batch BEGIN saw (batches are replaced,
never written in place)."""

import pytest

from torch_session_diff import MODES, port_session, run_script


def _t(s):
    s.register_table("t", {"id": [1, 2, 3], "v": [10.0, 20.0, 30.0]})


COUNT = "SELECT COUNT(*) FROM t"

CASES = {
    "rollback_insert": (_t, [
        "BEGIN", "INSERT INTO t VALUES (4, 40.0)", COUNT, "ROLLBACK", COUNT,
    ]),
    "commit_keeps": (_t, [
        "BEGIN", "INSERT INTO t VALUES (4, 40.0)", "COMMIT", COUNT,
    ]),
    "rollback_update_delete": (_t, [
        "BEGIN WORK", "UPDATE t SET v = 0.0 WHERE id = 1",
        "DELETE FROM t WHERE id = 3", COUNT, "ROLLBACK WORK",
        "SELECT id, v FROM t ORDER BY id",
    ]),
    "rollback_ddl_create_and_drop": (_t, [
        "BEGIN", "CREATE TABLE fresh (a INT)", "INSERT INTO fresh VALUES (1)",
        "DROP TABLE t", "SELECT * FROM fresh", "ROLLBACK", COUNT,
        "SELECT * FROM fresh",
    ]),
    "rollback_truncate_and_alter": (_t, [
        "BEGIN", "TRUNCATE TABLE t", COUNT,
        "ALTER TABLE t ADD COLUMN note TEXT", "ROLLBACK",
        "SELECT * FROM t ORDER BY id",
    ]),
    "failed_statement_aborts_transaction": (_t, [
        "BEGIN", "SELECT * FROM no_such_table", "SELECT 1", "SAVEPOINT s",
        "ROLLBACK", "SELECT 1",
    ]),
    "commit_of_failed_txn_is_rollback": (_t, [
        "BEGIN", "INSERT INTO t VALUES (4, 40.0)",
        "SELECT * FROM no_such_table", "COMMIT", COUNT,
    ]),
    "savepoints": (_t, [
        "BEGIN", "INSERT INTO t VALUES (4, 40.0)", "SAVEPOINT sp1",
        "INSERT INTO t VALUES (5, 50.0)", "SAVEPOINT sp2", "DELETE FROM t",
        "ROLLBACK TO SAVEPOINT sp2", COUNT, "ROLLBACK TO sp1", COUNT,
        "ROLLBACK TO sp1", "RELEASE SAVEPOINT sp1", "ROLLBACK TO sp1",
        "COMMIT", COUNT,
    ]),
    "rollback_to_recovers_failed_txn": (_t, [
        "BEGIN", "SAVEPOINT sp", "SELECT * FROM no_such_table",
        "ROLLBACK TO sp", "INSERT INTO t VALUES (4, 40.0)", "COMMIT", COUNT,
    ]),
    "savepoint_outside_txn_errors": (_t, [
        "SAVEPOINT sp", "RELEASE sp", "ROLLBACK TO sp", "COMMIT", "ROLLBACK",
    ]),
    "serial_counter_restored": (None, [
        "CREATE TABLE seq (id SERIAL, x INT)",
        "INSERT INTO seq (x) VALUES (100)", "BEGIN",
        "INSERT INTO seq (x) VALUES (101)", "INSERT INTO seq (x) VALUES (102)",
        "ROLLBACK", "INSERT INTO seq (x) VALUES (103)",
        "SELECT id, x FROM seq ORDER BY id",
    ]),
    "index_ddl_rollback": (_t, [
        "CREATE INDEX pre_idx ON t (id)", "BEGIN",
        "CREATE INDEX txn_idx ON t (v)", "DROP INDEX pre_idx", "ROLLBACK",
        "SELECT v FROM t WHERE id = 2",
    ]),
    "index_contents_rebuilt_on_rollback": (_t, [
        "CREATE INDEX idx ON t (id)", "BEGIN",
        "INSERT INTO t VALUES (9, 90.0)", "SELECT v FROM t WHERE id = 9",
        "ROLLBACK", "SELECT v FROM t WHERE id = 9",
        "SELECT v FROM t WHERE id = 3",
    ]),
    "nested_begin_is_noop": (_t, [
        "BEGIN", "INSERT INTO t VALUES (4, 40.0)", "BEGIN", "ROLLBACK", COUNT,
    ]),
    "start_transaction_end_aliases": (_t, [
        "START TRANSACTION", "INSERT INTO t VALUES (4, 40.0)", "END", COUNT,
    ]),
    "rollback_of_views_and_rename": (_t, [
        "BEGIN", "CREATE VIEW tv AS SELECT SUM(v) AS s FROM t",
        "ALTER TABLE t RENAME TO t2", "SELECT s FROM tv", "ROLLBACK",
        "SELECT s FROM tv", COUNT,
    ]),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_transaction_matches_jax(case, mode):
    setup, script = CASES[case]
    js, ts, _ = run_script(script, mode, setup)
    assert ts.tables() == js.tables() and ts.views() == js.views()
    assert ts.in_transaction() == js.in_transaction()
    assert ts.transaction_failed() == js.transaction_failed()


@pytest.mark.parametrize("mode", MODES)
def test_transaction_via_sql_script(mode):
    script = ("BEGIN; INSERT INTO t VALUES (4, 40.0); ROLLBACK;"
              "BEGIN; INSERT INTO t VALUES (5, 50.0); COMMIT;")
    js, ts, _ = run_script([], mode, _t)
    want = [b.to_pylist() for b in js.sql_script(script)]
    assert [b.to_pylist() for b in ts.sql_script(script)] == want
    q = "SELECT id FROM t ORDER BY id"
    assert ts.sql(q).to_pylist() == js.sql(q).to_pylist() == \
        [(1,), (2,), (3,), (5,)]


def test_index_state_after_rollback():
    """The index checks of tests/test_transactions.py on the port's
    sources: ROLLBACK drops an index made inside the transaction, brings
    back one dropped inside it, and rebuilds the contents."""
    s = port_session("compiled")
    _t(s)
    src = s.sources["t"]
    s.sql("CREATE INDEX pre_idx ON t (id)")
    s.sql("BEGIN")
    s.sql("CREATE INDEX txn_idx ON t (v)")
    s.sql("DROP INDEX pre_idx")
    s.sql("ROLLBACK")
    assert src.indexes.has_index("pre_idx")
    assert not src.indexes.has_index("txn_idx")
    assert list(src.index_lookup("pre_idx", (2,))) == [1]
    s.sql("BEGIN")
    s.sql("INSERT INTO t VALUES (9, 90.0)")
    assert list(src.index_lookup("pre_idx", (9,))) == [3]
    s.sql("ROLLBACK")
    assert list(src.index_lookup("pre_idx", (9,))) == []
    assert list(src.index_lookup("pre_idx", (3,))) == [2]


def test_rollback_restores_the_batch_begin_saw():
    """DML replaces the stored batch: after UPDATE, DELETE and INSERT the
    batch BEGIN saw still holds its rows, and ROLLBACK puts that very
    object back."""
    s = port_session("compiled")
    _t(s)
    before = s.sources["t"].scan()
    planes = [(c.data.clone(), c.validity.clone()) for c in before.columns]
    s.sql("BEGIN")
    s.sql("UPDATE t SET v = -1.0")
    s.sql("DELETE FROM t WHERE id = 2")
    s.sql("INSERT INTO t VALUES (7, 70.0)")
    assert s.sources["t"].scan() is not before
    for (d, v), c in zip(planes, before.columns):
        assert c.data.equal(d) and c.validity.equal(v)
    s.sql("ROLLBACK")
    assert s.sources["t"].scan() is before
    assert s.sql("SELECT * FROM t ORDER BY id").to_pylist() == \
        [(1, 10.0), (2, 20.0), (3, 30.0)]
