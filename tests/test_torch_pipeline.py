"""The port's compiled pipeline against its eager executor and the JAX
package.

Every query runs through three Sessions on the same tables: the port with
the compiled pipeline (the default), the port with it off (the eager
oracle), and the JAX package's Session. Rows and schema names must agree;
integers exactly, floats to rtol 1e-9 (the tolerance of
tests/test_pallas_kernels.py; most queries here are exact). Each query also
asserts that the compiled path engaged, so a silent eager fallback cannot
pass. The slice's two full queries run at 2^14 fact rows and 1024
dimension rows: Query A (the bench query: direct-rank FK join,
fk_gather_by_rank, bucket GROUP BY, group_agg, top-k) and Query B (a float
dimension column, so the join takes fk_join_right_lookup and the packed
gather, through the small-table gather when QE_MXU_GATHER=1); Query B's
float sums are exact by construction.
"""

import math
import os

import numpy as np
import pytest

from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.columnar.convert import from_numpy_batch
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import small_gather

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
)

NULLS = {
    "k": [1, 2, None, 2, 1, None, 3],
    "v": [10.5, None, 3.0, 4.5, None, 6.0, 7.25],
    "s": ["a", "b", None, "b", "a", "c", None],
}

JOIN = "employees JOIN departments ON employees.dept_id = departments.dept_id"
JOIN_MIRRORED = ("departments JOIN employees "
                 "ON departments.dept_id = employees.dept_id")

# (query, joins the compiled segment must inline); the subset of
# tests/test_compiled_pipeline.py that lies in this slice
QUERIES = [
    # filter + project
    ("SELECT name, age FROM employees WHERE age > 25", 0),
    ("SELECT name, salary * 2, salary / 1000 FROM employees WHERE id = 1", 0),
    ("SELECT name FROM employees WHERE age > 25 AND salary < 90000 "
     "OR id = 1", 0),
    ("SELECT name FROM employees WHERE dept_id IS NULL", 0),
    ("SELECT name, salary - 1000, -age, salary / 7.0 FROM employees", 0),
    # sort / limit / offset
    ("SELECT name, salary FROM employees ORDER BY salary DESC", 0),
    ("SELECT name FROM employees ORDER BY age LIMIT 3 OFFSET 1", 0),
    ("SELECT name FROM employees WHERE age > 25 "
     "ORDER BY dept_id, salary DESC", 0),
    ("SELECT name, dept_id, age FROM employees "
     "ORDER BY dept_id DESC NULLS LAST, age LIMIT 3 OFFSET 1", 0),
    # aggregates: global, grouped (int + string keys), HAVING
    ("SELECT COUNT(*), SUM(salary), AVG(age), MIN(age), MAX(age) "
     "FROM employees", 0),
    ("SELECT dept_id, COUNT(*), SUM(salary), AVG(salary) FROM employees "
     "GROUP BY dept_id ORDER BY dept_id", 0),
    ("SELECT dept_id, MIN(name), MAX(salary) FROM employees "
     "GROUP BY dept_id ORDER BY dept_id", 0),
    ("SELECT dept_id, COUNT(*) AS c FROM employees GROUP BY dept_id "
     "HAVING COUNT(*) > 1 ORDER BY c DESC, dept_id", 0),
    ("SELECT dept_name, COUNT(*) FROM departments GROUP BY dept_name "
     "ORDER BY dept_name", 0),
    ("SELECT dept_id, COUNT(*) FROM employees WHERE age > 100 "
     "GROUP BY dept_id", 0),
    # INNER FK joins in-segment (dept_id is unique in departments)
    (f"SELECT employees.name, departments.dept_name FROM {JOIN} "
     "WHERE employees.age > 25 ORDER BY employees.name", 1),
    (f"SELECT departments.dept_name, COUNT(*) FROM {JOIN} "
     "GROUP BY departments.dept_name ORDER BY departments.dept_name", 1),
    (f"SELECT departments.dept_name, SUM(employees.salary) AS s FROM {JOIN} "
     "WHERE employees.age > 25 GROUP BY departments.dept_name "
     "ORDER BY s DESC", 1),
    # mirrored FK fast path: the UNIQUE side is the LEFT table
    (f"SELECT departments.dept_name, employees.name FROM {JOIN_MIRRORED} "
     "ORDER BY employees.id", 1),
    (f"SELECT departments.dept_name, SUM(employees.salary) AS s "
     f"FROM {JOIN_MIRRORED} WHERE employees.age > 25 "
     "GROUP BY departments.dept_name ORDER BY s DESC", 1),
    # multi-key join with a unique composite build side (id, dept_id)
    ("SELECT a.name, b.salary FROM employees a JOIN employees b "
     "ON a.id = b.id AND a.dept_id = b.dept_id ORDER BY a.id", 1),
    # self-join on a non-unique key (multiplicity 2): a bounded emit in the
    # program, as the JAX package's pipeline runs it
    ("SELECT a.name, b.name FROM employees a JOIN employees b "
     "ON a.dept_id = b.dept_id WHERE a.id < b.id ORDER BY a.id, b.id", 1),
    # null semantics on a table with NULL keys and values
    ("SELECT k, COUNT(*), SUM(v), AVG(v), MIN(v), MAX(v) FROM nv "
     "GROUP BY k ORDER BY k", 0),
    ("SELECT s, COUNT(v) FROM nv GROUP BY s ORDER BY s", 0),
    ("SELECT k, v FROM nv WHERE v IS NOT NULL ORDER BY v DESC LIMIT 3", 0),
    ("SELECT k FROM nv ORDER BY k", 0),
]

QUERY_A = (
    "SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
    "FROM f JOIN d ON f.dept = d.dept_id "
    "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10"
)
QUERY_B = (
    "SELECT f.dept, COUNT(*) AS c, SUM(f.salary * d.rate + d.bonus) AS s "
    "FROM f JOIN d ON f.dept = d.dept_id "
    "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10"
)


def _same_rows(got, want):
    """Rows equal; floats to rtol 1e-9, NaN equal to NaN."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None, (g, w)
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def _register_fixtures(s):
    s.register_csv("employees", os.path.join(DATA, "employees.csv"))
    s.register_csv("departments", os.path.join(DATA, "departments.csv"))
    s.register_table("nv", dict(NULLS))


def _port_session(compiled=True):
    s = Session(device="cpu")
    _register_fixtures(s)
    s.executor._compiled = compiled
    return s


@pytest.fixture(scope="module")
def sessions():
    js = JSession()
    _register_fixtures(js)
    return _port_session(True), _port_session(False), js


def _engaged(stats):
    return stats["compiles"] + stats["hits"]


@pytest.mark.parametrize("q,joins", QUERIES, ids=lambda q: str(q)[:64])
def test_compiled_matches_eager_and_jax(sessions, q, joins):
    fast, slow, js = sessions
    st = fast.executor.pipeline.stats
    before, inlined = _engaged(st), st["joins_inlined"]
    a = fast.sql(q)
    assert _engaged(st) > before, f"compiled path did not engage: {st}"
    assert st["joins_inlined"] - inlined >= joins, st
    b = slow.sql(q)
    want = js.sql(q)
    assert a.schema.names() == b.schema.names() == want.schema.names()
    _same_rows(a.to_pylist(), b.to_pylist())
    _same_rows(a.to_pylist(), want.to_pylist())


def test_cache_reuse():
    s = _port_session()
    s.sql("SELECT name FROM employees WHERE age > 25")
    c0 = dict(s.executor.pipeline.stats)
    out = s.sql("SELECT name FROM employees WHERE age > 25")
    c1 = s.executor.pipeline.stats
    assert c1["compiles"] == c0["compiles"]
    assert c1["hits"] == c0["hits"] + 1
    assert out.to_pylist() == [
        ("Bob",), ("Charlie",), ("Diana",), ("Eve",), ("Frank",),
    ]


def test_one_program_for_two_literal_values():
    """Numeric literals are program inputs: one program serves every
    value."""
    s = _port_session()
    c0 = dict(s.executor.pipeline.stats)
    outs = [
        s.sql(f"SELECT name FROM employees WHERE age > {a} ORDER BY name")
        for a in (25, 28, 30)
    ]
    c1 = s.executor.pipeline.stats
    assert c1["compiles"] == c0["compiles"] + 1
    assert c1["hits"] == c0["hits"] + 2
    assert outs[0].to_pylist() == [("Bob",), ("Charlie",), ("Diana",),
                                   ("Eve",), ("Frank",)]
    assert outs[2].to_pylist() == [("Charlie",), ("Eve",)]


def test_reregistered_table_gives_new_rows():
    """A table registered anew at the same capacity reuses the program and
    must be read afresh (on the card: the graph's leaf planes change)."""
    s = _port_session()
    q = "SELECT x FROM t WHERE y >= 20 ORDER BY x DESC"
    s.register_table("t", {"x": [1, 2, 3], "y": [10, 20, 30]})
    assert s.sql(q).to_pylist() == [(3,), (2,)]
    c0 = dict(s.executor.pipeline.stats)
    s.register_table("t", {"x": [1, 2, 3, 4], "y": [10, 20, 30, 40]})
    assert s.sql(q).to_pylist() == [(4,), (3,), (2,)]
    c1 = s.executor.pipeline.stats
    assert c1["compiles"] == c0["compiles"]
    assert c1["hits"] == c0["hits"] + 1


def _bench_tables(n_fact, seed):
    """Queries A and B's tables (chip_smoke.make_tables' distributions),
    as JAX batches: the fact table and, per query, its dimension table;
    Query B's adds `rate` = integers(128, 384) / 256."""
    rng = np.random.default_rng(seed)
    f = JBatch.from_pydict({
        "age": rng.integers(18, 65, n_fact),
        "salary": rng.integers(50_000, 150_000, n_fact),
        "dept": rng.integers(0, 1024, n_fact),
    })
    dim = {"dept_id": np.arange(1024), "bonus": rng.integers(0, 1000, 1024)}
    rate = rng.integers(128, 384, 1024) / 256
    return f, {QUERY_A: JBatch.from_pydict(dim),
               QUERY_B: JBatch.from_pydict({**dim, "rate": rate})}


def _port(b):
    planes = [(np.asarray(c.data), np.asarray(c.validity),
               None if c.dictionary is None else c.dictionary.values)
              for c in b.columns]
    return from_numpy_batch(list(b.schema), planes, b.num_rows, "cpu")


@pytest.fixture(scope="module")
def bench_reference():
    f, dims = _bench_tables(1 << 14, 7)
    want = {}
    for q, d in dims.items():
        js = JSession()
        js.register_table("f", f)
        js.register_table("d", d)
        want[q] = js.sql(q).to_pylist()
    return f, dims, want


@pytest.mark.parametrize("query", ["A", "B"])
@pytest.mark.parametrize("mxu_gather", ["0", "1"])
def test_queries_a_and_b(bench_reference, monkeypatch, query, mxu_gather):
    """Compiled == eager == JAX, exactly; the small-table gather runs for
    Query B exactly when QE_MXU_GATHER=1."""
    f, dims, want = bench_reference
    q = QUERY_A if query == "A" else QUERY_B
    d = dims[q]
    monkeypatch.setenv("QE_MXU_GATHER", mxu_gather)
    calls = []
    real = small_gather.gather_word_planes

    def counted(idx, planes):
        calls.append(tuple(planes.shape))
        return real(idx, planes)

    monkeypatch.setattr(small_gather, "gather_word_planes", counted)
    fast, slow = Session(device="cpu"), Session(device="cpu")
    slow.executor._compiled = False
    for s in (fast, slow):
        s.register_table("f", _port(f))
        s.register_table("d", _port(d))
    got = fast.sql(q).to_pylist()
    st = fast.executor.pipeline.stats
    assert st["compiles"] == 1 and st["joins_inlined"] >= 1, st
    assert got == want[q]
    assert len(got) == 10
    assert slow.sql(q).to_pylist() == got
    assert fast.sql(q).to_pylist() == got  # a warm run: a cache hit
    assert st["hits"] == 1, st
    uses_gather = query == "B" and mxu_gather == "1"
    # one packed word per fact row: bonus and the validity bits (the join
    # gathers only the columns the query reads: bonus and rate)
    assert calls == ([(1, 1024)] * 2 if uses_gather else []), calls


def test_warm_query_a_reads_the_device_once(bench_reference):
    f, dims, want = bench_reference
    d = dims[QUERY_A]
    s = Session(device="cpu")
    s.register_table("f", _port(f))
    s.register_table("d", _port(d))
    assert s.sql(QUERY_A).to_pylist() == want[QUERY_A]  # cold: stats reads
    syncs = s.executor.host_syncs
    assert s.sql(QUERY_A).to_pylist() == want[QUERY_A]
    assert s.executor.host_syncs - syncs == 1  # the result's row count


def test_compiled_can_be_switched_off(monkeypatch):
    monkeypatch.setenv("QE_COMPILED", "0")
    s = Session(device="cpu")
    _register_fixtures(s)
    assert s.sql("SELECT name FROM employees WHERE age > 25 "
                 "ORDER BY name").to_pylist()[0] == ("Bob",)
    st = s.executor.pipeline.stats
    assert st["compiles"] + st["hits"] + st["fallbacks"] == 0, st


def test_explain_analyze_shows_the_segment():
    s = _port_session()
    lines = [r[0] for r in s.sql(
        "EXPLAIN ANALYZE SELECT dept_id, COUNT(*) FROM employees "
        "GROUP BY dept_id ORDER BY dept_id"
    ).to_pylist()]
    assert any(line.startswith("compiled_pipeline") for line in lines), lines


@pytest.mark.parametrize("fails", [False, True])
def test_capture_defers_cyclic_collection(monkeypatch, fails):
    """The cyclic collector is off while a CUDA graph captures (a
    collection there may free another graph, which CUDA refuses during a
    capture) and on again afterwards, also when the body raises. The
    capture runs in thread-local mode under the capture lock. The CUDA
    graph calls are stood in by fakes on the CPU."""
    import contextlib
    import gc

    import torch

    from query_engine_tpu_torch.engine import pipeline as P

    modes = []

    def fake_graph(g, **kwargs):
        modes.append(kwargs.get("capture_error_mode"))
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    pipe = Session(device="cpu").executor.pipeline
    seen = []

    def body(*args):
        seen.append(gc.isenabled())
        assert P._CAPTURE_LOCK._is_owned()
        if fails:
            raise RuntimeError("body failed")
        return []

    monkeypatch.setattr(pipe, "_body", body)
    assert gc.isenabled()
    entry = P._Entry(None, [])
    with (pytest.raises(RuntimeError) if fails
          else contextlib.nullcontext()):
        pipe._capture(entry, [], [], [])
    assert seen == [False] and gc.isenabled()
    assert modes == ["thread_local"]
    assert (entry.graph is None) == fails
    assert not P._CAPTURE_LOCK._is_owned()


def test_captures_of_two_sessions_take_turns(monkeypatch):
    """A capture waits while another thread's capture (another Session's)
    holds the capture lock, and its cyclic collector stays off until its
    own capture ends. Fakes stand in for the CUDA graph calls."""
    import contextlib
    import gc
    import threading

    import torch

    from query_engine_tpu_torch.engine import pipeline as P

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kwargs: contextlib.nullcontext())
    pipes = [Session(device="cpu").executor.pipeline for _ in range(2)]
    events, inside = [], threading.Event()
    release = threading.Event()

    def body_a(*args):
        events.append("a in")
        inside.set()
        assert release.wait(10)
        events.append(("a out", gc.isenabled()))
        return []

    def body_b(*args):
        events.append(("b", gc.isenabled()))
        return []

    monkeypatch.setattr(pipes[0], "_body", body_a)
    monkeypatch.setattr(pipes[1], "_body", body_b)
    a = threading.Thread(target=pipes[0]._capture,
                         args=(P._Entry(None, []), [], [], []))
    b = threading.Thread(target=pipes[1]._capture,
                         args=(P._Entry(None, []), [], [], []))
    a.start()
    assert inside.wait(10)
    b.start()
    b.join(0.2)
    assert b.is_alive() and events == ["a in"]
    release.set()
    a.join(10)
    b.join(10)
    assert events == ["a in", ("a out", False), ("b", False)]
    assert gc.isenabled()
    assert [p.stats["captures"] for p in pipes] == [1, 1]
