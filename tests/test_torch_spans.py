"""The port's spans and counters, on the CPU.

`utils.profiling.span` marks a phase of a statement: a `qe:<name>` range
while a torch profiler records, none otherwise, and its host ms added to a
counter where one is given. The compiled pipeline's phase counters
(`leaf_ms`, `room_ms`, `capture_ms`, the executor's `sync_ms`) never count
one millisecond twice, and a cached entry's captures are counted by their
cause (`recaptures_released`, `recaptures_moved`).

The graphs are `tests/torch_graph_stand_in.py`'s, or, where a capture's own
span is under test, the pipeline's real `_capture` over a CUDA graph whose
capture runs the body once and whose replay does nothing (every statement
that replays it captured it over the same inputs first).
"""

import contextlib
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.utils import profiling
from query_engine_tpu_torch.utils.profiling import span

from torch_graph_stand_in import stand_in_graphs

T = {"k": [i % 7 for i in range(300)],
     "v": [float(i % 23) for i in range(300)]}
U = {"k": list(range(7)),
     "name": ["ant", "bee", "asp", "cat", "auk", "dog", "ape"]}
# the LIKE filter over u is an eager leaf where the pipeline admits nodes
# as on CUDA: each run hands the program a new batch, so a cached graph
# captures again over the new planes
QUERY = ("SELECT t.k, COUNT(*) AS c, SUM(t.v) AS s FROM t "
         "JOIN (SELECT k FROM u WHERE name LIKE 'a%') a ON t.k = a.k "
         "GROUP BY t.k ORDER BY t.k")
SIMPLE = "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
PHASES = ("leaf_ms", "room_ms", "capture_ms", "sync_ms")


def _session(graphs=None):
    s = Session(device="cpu")
    s.register_table("t", T)
    s.register_table("u", U)
    if graphs == "stand_in":
        stand_in_graphs(s.executor.pipeline)
    elif graphs == "capture":
        s.executor.pipeline._graphs = True
    return s


@pytest.fixture(scope="module")
def want():
    s = _session()
    s.executor._compiled = False
    return {q: s.sql(q).to_pylist() for q in (QUERY, SIMPLE)}


class _Graph:
    def replay(self):
        pass


@pytest.fixture
def real_capture(monkeypatch):
    """The pipeline's own `_capture` on the CPU: a graph whose capture runs
    the body (eagerly, inside the `torch.cuda.graph` block) and whose replay
    does nothing."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, **kw: contextlib.nullcontext())


def _deltas(pipe, before):
    return {k: v - before[k] for k, v in pipe.stats.items()}


# ---- (a) no profiler: no range, the total still counted -------------------
@pytest.mark.parametrize("case", ["totals", "raises", "statement"])
def test_span_without_a_profiler_opens_no_range(monkeypatch, want, case):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not torch._C._autograd._profiler_enabled()
    if case == "statement":
        s = _session("stand_in")
        assert s.sql(QUERY).to_pylist() == want[QUERY]
        st = s.executor.pipeline.stats
        assert st["sync_ms"] > 0 and st["leaf_ms"] > 0, st
        assert s.last_timing.parse_ms > 0 and s.last_timing.plan_ms > 0
        return
    totals = {}
    with contextlib.suppress(KeyError):
        with span("work", totals, "work_ms") as sp:
            time.sleep(0.002)
            if case == "raises":
                raise KeyError("the phase raised")
    assert sp.ms >= 2.0 and totals == {"work_ms": sp.ms}


# ---- (b) under the profiler: ranges nested by time ---------------------------
def _ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith((profiling.SPAN_PREFIX, "pipeline:",
                                  "test:"))]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_statement_spans_nest_under_the_profiler(want):
    s = _session("stand_in")
    pipe = s.executor.pipeline
    assert s.sql(QUERY).to_pylist() == want[QUERY]
    pipe.release_graphs()
    capture = pipe._capture

    def marked_capture(*args):
        with torch.profiler.record_function("test:capture"):
            capture(*args)

    pipe._capture = marked_capture
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rows = s.sql(QUERY).to_pylist()
    assert rows == want[QUERY]
    got = _ranges(prof)
    by = {}
    for r in got:
        by.setdefault(r[0], []).append(r)
    (sql,) = by["qe:sql"]
    for name in ("qe:parse", "qe:plan", "qe:execute"):
        (r,) = by[name]
        assert _inside(r, sql), (name, r, sql)
    (execute,) = by["qe:execute"]
    for name in ("qe:sync", "qe:leaf", "qe:room", "qe:replay"):
        assert by[name] and all(_inside(r, execute) for r in by[name]), name
    # the rows' read follows the statement
    (result,) = by["qe:result"]
    assert result[1] >= sql[2]
    # the operators' ranges run inside the stood-in capture too
    (cap,) = by["test:capture"]
    assert any(_inside(r, cap) for name, rs in by.items()
               if name.startswith("pipeline:") for r in rs), sorted(by)


# ---- (c) recaptures by cause -----------------------------------------------
# moved wherever the inputs moved, released graph or not; released where
# only the graph went
@pytest.mark.parametrize("change,cause", [
    ("release", "released"), ("register", "moved"),
    ("release+register", "moved")])
def test_recaptures_counted_by_cause(want, change, cause):
    s = _session("stand_in")
    pipe = s.executor.pipeline
    for _ in range(2):  # compiled and captured, then replayed
        assert s.sql(SIMPLE).to_pylist() == want[SIMPLE]
    before = dict(pipe.stats)
    if "release" in change:
        pipe.release_graphs()
    if "register" in change:
        s.register_table("t", T)  # the same rows at new addresses
    assert s.sql(SIMPLE).to_pylist() == want[SIMPLE]
    d = _deltas(pipe, before)
    other = {"released": "moved", "moved": "released"}[cause]
    assert d[f"recaptures_{cause}"] == 1 and d[f"recaptures_{other}"] == 0
    assert d["captures"] == 1 and d["replays"] == 1 and d["compiles"] == 0


# ---- per thread: inside a leaf or a mesh shard body, a phase counts nothing
@pytest.mark.parametrize("state", ["leaf", "shard"])
def test_phase_counts_per_thread(state):
    pipe = Session(device="cpu").executor.pipeline
    attr = {"leaf": "_leaf_depth", "shard": "_in_shard"}[state]
    setattr(pipe, attr, {"leaf": 1, "shard": True}[state])

    def read():
        with pipe.phase("sync", "sync_ms"):
            time.sleep(0.001)

    read()
    assert pipe.stats["sync_ms"] == 0.0
    other = threading.Thread(target=read)
    other.start()
    other.join()
    assert pipe.stats["sync_ms"] > 0.0  # another thread's is its own


# ---- (d) phase counters within the statement's wall time -------------------
@pytest.mark.parametrize("run", ["first", "warm"])
def test_phase_ms_within_the_statement(real_capture, want, run):
    s = _session("capture")
    pipe = s.executor.pipeline
    if run == "warm":
        assert s.sql(QUERY).to_pylist() == want[QUERY]
    before = dict(pipe.stats)
    t0 = time.perf_counter()
    batch = s.sql(QUERY)
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert batch.to_pylist() == want[QUERY]
    d = _deltas(pipe, before)
    assert all(d[k] > 0 for k in PHASES), d
    assert d["captures"] >= 1, d
    if run == "warm":  # the leaf's new batch: the graph reads its planes
        assert d["recaptures_moved"] >= 1 and d["compiles"] == 0, d
    t = s.last_timing
    assert t.parse_ms + t.plan_ms + sum(d[k] for k in PHASES) <= wall_ms
    assert sum(d[k] for k in PHASES) <= t.execute_ms


def test_explain_analyze_prints_the_pipeline_phases(real_capture):
    s = _session("capture")
    s.sql(QUERY).to_pylist()
    lines = [r[0] for r in s.sql("EXPLAIN ANALYZE " + QUERY).to_pylist()]
    (line,) = [ln for ln in lines if ln.startswith("pipeline: ")]
    assert "captures=1 (released=0, moved=1)" in line, line
    for k in PHASES:
        assert f" {k}=" in line, line
