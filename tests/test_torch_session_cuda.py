"""The Session's DDL, DML, index, transaction and cache statements on the
card, held against a CPU Session on the same data. Each test skips without
a CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_session_cuda.py -m cuda

* after every statement of a script (CREATE TABLE then INSERT, UPDATE,
  DELETE, INSERT ... SELECT, ON CONFLICT, ALTER TABLE, CREATE TABLE AS,
  TRUNCATE, indexes and parameters, BEGIN/SAVEPOINT/ROLLBACK) every plane
  of every table lies on the card, and the statement's status or rows equal
  the CPU Session's: integers and strings exactly, floats to rtol 1e-9;
* DML never writes a stored plane: the planes a snapshot holds keep their
  bytes through UPDATE, DELETE and INSERT;
* the refresh statements of `tpch/refresh.py` (M1-M12) at
  `data.generate(1 << 11)` on the card equal the numpy oracle.
"""

import math

import pytest
import torch

from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.storage.memory import MemoryDataSource
from query_engine_tpu_torch.tpch import data, oracle, refresh

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=1e-9, abs_tol=0.0)
    return a == b and type(a) is type(b)


def _rows_equal(got, want):
    return len(got) == len(want) and all(
        len(g) == len(w) and all(_same(x, y) for x, y in zip(g, w))
        for g, w in zip(got, want))


def _outcome(s, stmt, params=None):
    try:
        b = s.sql(stmt, params)
        return ("ok", b.schema.names(), b.to_pylist())
    except Exception as e:  # noqa: BLE001 the type is the outcome
        return ("error", type(e).__name__)


def _on_card(s):
    for name, src in s.sources.items():
        if isinstance(src, MemoryDataSource):
            for c in src.scan().columns:
                assert c.data.is_cuda and c.validity.is_cuda, name


def _setup(s):
    s.register_table("w", {
        "id": list(range(1, 301)),
        "s": [None if i % 17 == 0 else f"k{i % 23}" for i in range(300)],
        "v": [i * 0.5 - 40 for i in range(300)],
    })


SCRIPT = [
    "CREATE TABLE t (id INT, name TEXT, price DECIMAL(10, 2), f DOUBLE "
    "PRECISION)",
    "INSERT INTO t VALUES (1, 'a', 19.99, 1.5), (2, 'b', 5.50, NULL), "
    "(3, NULL, NULL, -2.25)",
    "SELECT * FROM t ORDER BY id",
    "UPDATE t SET f = id * 1.5, name = 'zz' WHERE id >= 2",
    "UPDATE t SET id = f * 3 RETURNING *",
    "DELETE FROM t WHERE id = 3",
    "INSERT INTO t SELECT id + 100, s, v, v * 2 FROM w WHERE id % 7 = 0",
    "SELECT name, COUNT(*), SUM(f), MIN(price) FROM t GROUP BY name "
    "ORDER BY name NULLS FIRST",
    "INSERT INTO t VALUES (107, 'up', 1.0, 1.0), (999, 'new', 2.0, 2.0) "
    "ON CONFLICT (id) DO UPDATE SET f = 0.5 RETURNING id, f",
    "CREATE INDEX ti ON t (id)",
    ("SELECT id, name FROM t WHERE id >= $1 AND id < $2 ORDER BY id",
     [100, 140]),
    "ALTER TABLE t ADD COLUMN note VARCHAR",
    "ALTER TABLE t RENAME COLUMN f TO g",
    "BEGIN",
    "DELETE FROM t WHERE id > 200",
    "SAVEPOINT s1",
    "UPDATE t SET note = 'x'",
    "ROLLBACK TO s1",
    "SELECT COUNT(*), COUNT(note) FROM t",
    "ROLLBACK",
    "SELECT id, name, price, g, note FROM t ORDER BY id",
    "CREATE TABLE c AS SELECT name, SUM(g) AS total FROM t GROUP BY name",
    "SELECT * FROM c ORDER BY name NULLS LAST",
    "DELETE FROM w USING c WHERE w.s = c.name",
    "SELECT COUNT(*), MIN(s) FROM w",
    "TRUNCATE TABLE c",
    "INSERT INTO c VALUES ('q', 1.0)",
    "SELECT * FROM c",
    "DROP TABLE c",
]


@pytest.mark.parametrize("compiled", [True, False])
def test_statements_on_the_card_match_the_cpu(compiled):
    gpu, cpu = Session(device="cuda"), Session(device="cpu")
    for s in (gpu, cpu):
        s.executor._compiled = compiled
        _setup(s)
    for item in SCRIPT:
        stmt, params = item if isinstance(item, tuple) else (item, None)
        want = _outcome(cpu, stmt, params)
        got = _outcome(gpu, stmt, params)
        assert got[:2] == want[:2], (stmt, got, want)
        if want[0] == "ok":
            assert _rows_equal(got[2], want[2]), (stmt, got, want)
        _on_card(gpu)


def test_create_table_then_insert_on_the_card():
    s = Session(device="cuda")
    s.sql("CREATE TABLE e (a INT, b TEXT)")
    _on_card(s)
    assert s.sql("INSERT INTO e VALUES (1, 'x')").to_pylist() == \
        [("INSERT 0 1",)]
    _on_card(s)
    assert s.sql("SELECT * FROM e").to_pylist() == [(1, "x")]


def test_dml_writes_no_stored_plane():
    s = Session(device="cuda")
    _setup(s)
    before = s.sources["w"].scan()
    saved = [(c.data.clone(), c.validity.clone()) for c in before.columns]
    s.sql("UPDATE w SET v = -1.0, s = 'new' WHERE id < 100")
    s.sql("DELETE FROM w WHERE id > 250")
    s.sql("INSERT INTO w VALUES (1000, 'x', 1.0)")
    for (d, v), c in zip(saved, before.columns):
        assert torch.equal(c.data, d) and torch.equal(c.validity, v)
    _on_card(s)


def test_refresh_statements_on_the_card():
    n_li = 1 << 11
    tables = data.generate(n_li)
    s = Session(device="cuda")
    data.register(s, tables)
    st = refresh.State(dict(tables))
    count = refresh.refresh_count(n_li)
    rf = refresh.make_rf1(st, count, 11)
    refresh.register_staging(s, rf)

    def run(steps):
        for step in steps:
            got = refresh.run_step(s, step)
            if step.want is not None:
                oracle.compare(got, step.want(st), step.float_keys)
            if step.edit is not None:
                step.edit(st)
            _on_card(s)

    run(refresh.steps(st, count, 11, rf))
    rf2 = refresh.make_rf1(st, count, 21)
    refresh.register_staging(s, rf2)
    run(refresh.transaction_steps(st, count, 21, rf2))
    run(refresh.ddl_steps(st))
    assert s.executor.index_scans >= 4
