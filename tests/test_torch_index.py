"""Indexes and query parameters on the port's Session against the JAX
Session: the session-level cases of tests/test_index.py (the lowered plan
holds an IndexScan and the executor runs it; the index kept in sync by
INSERT, DELETE and UPDATE), equality and range lookups with a residual,
an IndexScan under an aggregate (an eager leaf of the program, nothing
falls back), `sql(query, params)`; and the bulk build: the native
indexes' numpy key encoding (`encode_key_columns`) byte for byte against
the per-row `encode_key_bytes`, a native index built from whole planes
against the Python index built row by row, and the Python fallback's
`bulk_load` against its `insert`."""

import datetime

import numpy as np
import pytest

from torch_session_diff import MODES, port_session, run_script

from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType
from query_engine_tpu_torch.index import native
from query_engine_tpu_torch.index.btree import BTreeIndex
from query_engine_tpu_torch.index.hash import HashIndex
from query_engine_tpu_torch.plan import physical as pp
from query_engine_tpu_torch.plan.lowering import Lowering
from query_engine_tpu_torch.sql.parser import parse_sql


def _t(s):
    s.register_table("t", {
        "id": list(range(100)),
        "v": [i * 10 for i in range(100)],
        "s": [f"w{i % 7}" for i in range(100)],
    })


def _lowered(s, q):
    plan = s.optimizer.optimize(s.planner.create_logical_plan(parse_sql(q)))
    return Lowering(s.sources).lower(plan)


CASES = {
    "index_scan_equality_and_range": (_t, [
        "CREATE INDEX idx_id ON t (id)",
        "SELECT v FROM t WHERE id = 42",
        "SELECT id FROM t WHERE id > 95 ORDER BY id",
        "SELECT id FROM t WHERE id >= 10 AND id < 13 ORDER BY id",
        "SELECT id FROM t WHERE id > 90 AND v > 960 ORDER BY id",
        "SELECT id, s FROM t WHERE 50 > id AND id >= 47",
        "SELECT s, COUNT(*), SUM(v) FROM t WHERE id < 30 GROUP BY s "
        "ORDER BY s",
    ]),
    "hash_and_string_indexes": (_t, [
        "CREATE INDEX hs ON t (s) USING HASH",
        "SELECT id FROM t WHERE s = 'w3' ORDER BY id",
        "CREATE INDEX bs ON t (v)",
        "SELECT id FROM t WHERE v <= 45",
        "DROP INDEX hs",
        "SELECT COUNT(*) FROM t WHERE s = 'w3'",
    ]),
    "index_kept_in_sync_by_dml": (None, [
        "CREATE TABLE u (id INT, v TEXT)",
        "INSERT INTO u (id, v) VALUES (1, 'a'), (2, 'b')",
        "CREATE INDEX ix ON u (id)",
        "INSERT INTO u (id, v) VALUES (3, 'c')",
        "SELECT v FROM u WHERE id = 3",
        "DELETE FROM u WHERE id = 1",
        "SELECT v FROM u WHERE id = 1",
        "UPDATE u SET v = 'z' WHERE id = 2",
        "SELECT v FROM u WHERE id = 2",
        "INSERT INTO u SELECT id + 10, v FROM u",
        "SELECT id, v FROM u WHERE id >= 3 ORDER BY id",
    ]),
    "unique_index_violation": (None, [
        "CREATE TABLE u (id INT)",
        "INSERT INTO u VALUES (1), (1)",
        "CREATE UNIQUE INDEX ux ON u (id)",
    ]),
    "query_parameters": (_t, [
        ("SELECT v FROM t WHERE id = $1", [42]),
        ("SELECT id FROM t WHERE id >= $1 AND id < $2 ORDER BY id", [5, 9]),
        ("SELECT id FROM t WHERE s = $1 AND v > $2 ORDER BY id",
         ["w2", 500.5]),
        ("SELECT COUNT(*) FROM t WHERE id = $1", [None]),
        ("SELECT $1, $2", [True, "x"]),
        ("UPDATE t SET v = $1 WHERE id = $2", [-1, 7]),
        ("INSERT INTO t VALUES ($1, $2, $3)", [500, 5, "w9"]),
        "CREATE INDEX ip ON t (id)",
        ("SELECT v, s FROM t WHERE id = $1", [500]),
        ("SELECT v FROM t WHERE id = $1", [7]),
        ("DELETE FROM t WHERE id < $1", [50]),
        ("SELECT COUNT(*), MIN(id) FROM t WHERE id > $1", [0]),
    ]),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_index_matches_jax(case, mode):
    setup, script = CASES[case]
    run_script(script, mode, setup)


@pytest.mark.parametrize("mode", MODES)
def test_index_scan_in_plan_and_run(mode):
    """The lowered plan holds an IndexScan, the executor runs it (its
    counter moves), and an IndexScan under an aggregate is an eager leaf
    of the program: nothing falls back."""
    s = port_session(mode)
    _t(s)
    s.sql("CREATE INDEX idx_id ON t (id)")
    q = "SELECT v FROM t WHERE id = 42"
    assert "IndexScan" in _lowered(s, q).pretty()
    assert isinstance(_lowered(s, q).input, pp.PIndexScan)
    before = s.executor.index_scans
    assert s.sql(q).to_pylist() == [(420,)]
    assert s.executor.index_scans == before + 1
    q2 = "SELECT s, SUM(v) FROM t WHERE id BETWEEN 3 AND 40 GROUP BY s"
    got = sorted(s.sql(q2).to_pylist())
    want = {}
    for i in range(3, 41):
        want[f"w{i % 7}"] = want.get(f"w{i % 7}", 0) + 10 * i
    assert got == sorted(want.items())
    stats = s.executor.pipeline.stats
    assert stats["fallbacks"] == 0, stats
    if mode != "QE_COMPILED=0":
        assert s.executor.pipeline.leaf_kinds["IndexScan"] >= 1


def _key_batch(n, seed):
    rng = np.random.default_rng(seed)
    words = ["", "a", "zz", "mango", "é", "a b"]
    vals = {
        "i": [None if x % 11 == 0 else int(x) for x in
              rng.integers(-(1 << 40), 1 << 40, n)],
        "f": [None if x < -0.9 else float(x) for x in rng.uniform(-1, 1, n)],
        "s": [None if x == 0 else words[x] for x in rng.integers(0, 6, n)],
        "d": [None if x < 5 else datetime.date(1990, 1, 1)
              + datetime.timedelta(days=int(x)) for x in
              rng.integers(0, 3000, n)],
        "m": [None if x > 0.95 else round(float(x) * 100, 2)
              for x in rng.uniform(-50, 50, n)],
        "b": [None if x == 2 else bool(x) for x in rng.integers(0, 3, n)],
        "h": [int(x) for x in rng.integers(-3, 3, n)],
    }
    schema = Schema([Field("i", DataType.int64()),
                     Field("f", DataType.float64()),
                     Field("s", DataType.utf8()),
                     Field("d", DataType.date32()),
                     Field("m", DataType.decimal128(10, 2)),
                     Field("b", DataType.boolean()),
                     Field("h", DataType.int32())])
    vals["f"][3] = -0.0
    return ColumnBatch.from_pydict(vals, schema)


@pytest.mark.parametrize("cols", [["i"], ["f"], ["s"], ["d"], ["m"], ["b"],
                                  ["h"], ["s", "i"], ["d", "f", "b"],
                                  ["m", "s", "h", "i"]])
def test_encode_key_columns_matches_per_row_encoding(cols):
    b = _key_batch(300, len(cols))
    n = b.num_rows
    keys, off = native.encode_key_columns([b.column(c) for c in cols], n)
    rows = zip(*[b.column(c).to_pylist(n) for c in cols])
    want = [native.encode_key_bytes(r) for r in rows]
    assert [keys[off[i]:off[i + 1]] for i in range(n)] == want


@pytest.mark.skipif(not native.native_available(), reason="no C++ toolchain")
@pytest.mark.parametrize("kind", ["btree", "hash"])
def test_native_bulk_build_matches_python_index(kind):
    """A native index built from whole planes holds the rows the Python
    index built one insert a row holds: each key's rows (in insertion order
    for the btree; the hash's order is its own), and the btree's ranges
    over a numeric key. (Over strings the native order is by length first:
    its keys are length-prefixed, the reference's encoding.)"""
    b = _key_batch(2000, 9)
    cols = ["h", "s"]
    nat = native.NativeBTreeIndex() if kind == "btree" \
        else native.NativeHashIndex()
    nat.bulk_load_columns([b.column(c) for c in cols], b.num_rows, 5)
    py = BTreeIndex() if kind == "btree" else HashIndex()
    keys = list(zip(*[b.column(c).to_pylist(b.num_rows) for c in cols]))
    for i, k in enumerate(keys):
        py.insert(k, i + 5)
    assert len(nat) == len(py) == 2000
    for k in set(keys):
        if kind == "btree":
            assert nat.lookup(k) == py.lookup(k)
        else:
            assert sorted(nat.lookup(k)) == sorted(py.lookup(k))
    if kind == "btree":
        nat1, py1 = native.NativeBTreeIndex(), BTreeIndex()
        nat1.bulk_load_columns([b.column("i")], b.num_rows)
        py1.bulk_load_columns([b.column("i")], b.num_rows)
        for lo, hi in (((-(1 << 39),), (1 << 38,)), (None, (0,)),
                       ((5,), None)):
            assert nat1.range_scan(lo, hi) == py1.range_scan(lo, hi)
            assert nat1.range_scan(lo, hi, False, False) == \
                py1.range_scan(lo, hi, False, False)


def test_python_bulk_load_matches_insert():
    """The Python fallback builds from whole planes through the base
    `bulk_load_columns`, inserting row by row as the reference does."""
    b = _key_batch(500, 3)
    cols = [b.column("h"), b.column("s")]
    keys = list(zip(*[c.to_pylist(b.num_rows) for c in cols]))
    for cls in (BTreeIndex, HashIndex):
        a, bulk = cls(), cls()
        for i, k in enumerate(keys):
            a.insert(k, i + 7)
        bulk.bulk_load_columns(cols, b.num_rows, 7)
        assert a._map == bulk._map and len(a) == len(bulk) == 500
    u = BTreeIndex(unique=True)
    with pytest.raises(Exception, match="unique"):
        u.bulk_load_columns([b.column("h")], b.num_rows)


def test_session_index_without_native(monkeypatch):
    """QE_NO_NATIVE=1 builds the Python indexes through the same bulk
    path; lookups after DML agree with the native run."""
    rows = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("QE_NO_NATIVE", flag)
        s = port_session("compiled")
        _t(s)
        s.sql("CREATE INDEX a ON t (id)")
        s.sql("CREATE INDEX b ON t (s) USING HASH")
        s.sql("DELETE FROM t WHERE id % 3 = 0")
        s.sql("INSERT INTO t VALUES (1000, 1, 'w1')")
        kind = type(s.sources["t"].indexes.get("a")).__name__
        assert (kind == "BTreeIndex") == (flag == "1" or
                                           not native.native_available())
        rows[flag] = [s.sql(q).to_pylist() for q in (
            "SELECT id FROM t WHERE s = 'w1' ORDER BY id",
            "SELECT id, v FROM t WHERE id >= 90",
            "SELECT v FROM t WHERE id = 1000")]
    assert rows["0"] == rows["1"]
