"""Capacity-chunked aggregate execution in the port
(`query_engine_tpu_torch/engine/chunked.py`) against the unchunked port and
the JAX package, on the cases of tests/test_chunked.py (same seeded
tables), with the engage threshold lowered so the path runs at test sizes
(QE_CHUNK_ENGAGE=1024, QE_CHUNK_ROWS=512: 10 chunks of the 5,000-row fact
table).

Each case runs the port chunked, the port unchunked and the JAX Session
(unchunked), in two modes: the compiled pipeline as on the CPU, and
`graphs`, where the pipeline admits nodes as on CUDA and a stand-in graph
(tests/torch_graph_stand_in.py) "captures" a program by keeping its input
planes and "replays" it by running the body again over those same planes,
writing into the first run's output tensors, as a CUDA graph does: a replay reads the planes
the capture kept, so a chunk runs right by replay only because it is
staged into those same planes (a chunk whose planes moved is captured
again, which the replay test counts). Also:

* the outer-join gate: a RIGHT join whose unchunked side is outer is not
  chunked, and its unmatched row appears once;
* a DISTINCT aggregate is not chunked;
* the staging planes keep their addresses from chunk to chunk and from
  query to query, each chunk holds its rows of the table, and the table's
  column stats ride along;
* under `graphs`, a warm chunked query makes no capture and one replay a
  chunk.

Integers exactly, floats to rtol 1e-9.
"""

import math

import numpy as np
import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine import chunked
from query_engine_tpu_torch.engine.session import Session

from torch_graph_stand_in import stand_in_graphs

RTOL = 1e-9
ENGAGE, ROWS = 1024, 512

RNG = np.random.default_rng(23)
N = 5000
FACT = {
    "k": RNG.integers(0, 40, N).tolist(),
    "v": RNG.integers(1, 1000, N).tolist(),
    "f": RNG.normal(10, 3, N).round(4).tolist(),
}
for i in range(0, N, 77):
    FACT["v"][i] = None
for i in range(0, N, 53):
    FACT["k"][i] = None
DIM = {"d_id": list(range(40)), "w": RNG.integers(0, 100, 40).tolist()}
CHUNKS = -(-N // ROWS)  # chunks holding rows: 10

CASES = {
    "group_sum_count": "SELECT k, COUNT(*) AS c, SUM(v) AS s FROM fact "
                       "GROUP BY k ORDER BY k NULLS LAST",
    "having_and_limit_above": "SELECT k, SUM(v) AS s FROM fact GROUP BY k "
                              "HAVING COUNT(*) > 10 ORDER BY s DESC LIMIT 7",
    "fk_join_below_aggregate": "SELECT f.k, SUM(f.v + d.w) AS s, "
                               "MIN(d.w) AS mw FROM fact f JOIN dim d ON "
                               "f.k = d.d_id WHERE f.v > 50 GROUP BY f.k "
                               "ORDER BY f.k",
    "avg_min_max": "SELECT k, AVG(v) AS a, MIN(v) AS lo, MAX(v) AS hi "
                   "FROM fact WHERE v IS NOT NULL GROUP BY k "
                   "ORDER BY k NULLS LAST",
    "left_join_big_side_outer_ok": "SELECT f.k, COUNT(d.w) AS c FROM fact f "
                                   "LEFT JOIN dim d ON f.k = d.d_id GROUP BY "
                                   "f.k ORDER BY f.k NULLS LAST",
    # beyond tests/test_chunked.py: a float SUM and AVG, a global aggregate
    "float_sum_avg": "SELECT k, SUM(f) AS s, AVG(f) AS a, COUNT(f) AS n "
                     "FROM fact GROUP BY k ORDER BY k NULLS LAST",
    "global": "SELECT COUNT(*), SUM(v), AVG(f), MIN(f), MAX(v) FROM fact",
}
MODES = ["compiled", "graphs"]


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setenv("QE_CHUNK_ENGAGE", str(ENGAGE))
    monkeypatch.setenv("QE_CHUNK_ROWS", str(ROWS))


def port_session(mode, fact=FACT, dim=DIM):
    s = Session(device="cpu")
    if mode == "graphs":
        stand_in_graphs(s.executor.pipeline)
    s.register_table("fact", fact)
    s.register_table("dim", dim)
    return s


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=RTOL, abs_tol=0.0)
    return a == b and type(a) is type(b)


def same(got, want):
    assert len(got) == len(want), (got[:3], want[:3])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w)), \
            (g, w)


@pytest.fixture(scope="module")
def jax_rows():
    js = JSession()
    js.register_table("fact", FACT)
    js.register_table("dim", DIM)
    return {name: js.sql(sql).to_pylist() for name, sql in CASES.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_matches_unchunked_and_jax(name, mode, jax_rows,
                                           monkeypatch):
    sql = CASES[name]
    plain = port_session(mode)
    unchunked = plain.sql(sql).to_pylist()
    assert plain.executor.chunked.stats["queries"] == 0
    monkeypatch.setenv("QE_CHUNK_ENGAGE", str(ENGAGE))
    monkeypatch.setenv("QE_CHUNK_ROWS", str(ROWS))
    s = port_session(mode)
    st = s.executor.chunked.stats
    for run in range(2):  # first, then warm
        got = s.sql(sql).to_pylist()
        assert st["queries"] == run + 1 and st["chunks"] == CHUNKS * (run + 1)
        same(got, unchunked)
        same(got, jax_rows[name])


@pytest.mark.parametrize("name", ["group_sum_count", "fk_join_below_aggregate",
                                  "float_sum_avg"])
def test_warm_chunked_query_replays_without_capture(name, small_chunks):
    s = port_session("graphs")
    st = s.executor.chunked.stats
    s.sql(CASES[name])
    assert st["captures"] == 1 and st["replays"] == CHUNKS - 1
    before = dict(st)
    s.sql(CASES[name])
    assert st["captures"] == before["captures"]
    assert st["replays"] - before["replays"] == CHUNKS


def test_staging_planes_keep_their_addresses(small_chunks, monkeypatch):
    s = port_session("compiled")
    agg = s.executor.chunked
    seen = []
    stage = agg.stage_chunk

    def spy(batch, lo, cc, rows):
        out = stage(batch, lo, cc, rows)
        assert out.capacity == ROWS and out.num_rows == rows
        assert rows == min(ROWS, N - lo)
        for c, t in zip(out.columns, batch.columns):
            # the chunk's planes hold its rows: copied, not a view
            assert c.data.equal(t.data[lo: lo + ROWS])
            assert c.validity.equal(t.validity[lo: lo + ROWS])
            assert c.data.data_ptr() != t.data.data_ptr()
            assert c._qe_bounds == t._qe_bounds
        seen.append(tuple((c.data.data_ptr(), c.validity.data_ptr())
                          for c in out.columns))
        return out

    monkeypatch.setattr(agg, "stage_chunk", spy)
    for _ in range(2):
        s.sql(CASES["fk_join_below_aggregate"])
    assert len(seen) == 2 * CHUNKS
    assert len(set(seen)) == 1
    assert len(agg._staging) == 1


def test_right_join_small_outer_not_chunked(small_chunks):
    # unmatched DIM rows would be emitted once per chunk: gate must reject
    for mode in MODES:
        s = port_session(mode, dim={"d_id": [1, 2, 999], "w": [5, 6, 7]})
        r = s.sql(
            "SELECT d.d_id, COUNT(f.v) AS c FROM fact f "
            "RIGHT JOIN dim d ON f.k = d.d_id GROUP BY d.d_id "
            "ORDER BY d.d_id"
        ).to_pylist()
        assert s.executor.chunked.stats["queries"] == 0
        # d_id=999 matches nothing: COUNT(f.v)=0, exactly once
        assert r[-1] == (999, 0)


def test_distinct_agg_not_chunked(small_chunks):
    s = port_session("compiled")
    s.sql("SELECT k, COUNT(DISTINCT v) FROM fact GROUP BY k")
    assert s.executor.chunked.stats["queries"] == 0


def test_eager_executor_does_not_chunk(small_chunks):
    s = port_session("compiled")
    s.executor._compiled = False  # what QE_COMPILED=0 sets
    s.sql(CASES["group_sum_count"])
    assert s.executor.chunked.stats["queries"] == 0


def test_engage_and_chunk_defaults(monkeypatch):
    monkeypatch.delenv("QE_CHUNK_ENGAGE", raising=False)
    monkeypatch.delenv("QE_CHUNK_ROWS", raising=False)
    assert chunked.chunk_engage_rows() == 1 << 27
    assert chunked.chunk_rows() == 1 << 25
