"""The compiled pipeline's room for CUDA graphs, on the CPU: before a
capture that the card's free memory would not hold, and before a first
run, the graphs of the least recently used entries are released, LRU
first, until it does; a released entry captures again when it runs next;
a query that runs out of device memory releases every graph and runs once
more.

The graphs are `tests/torch_graph_stand_in.py`'s; the card's memory is a
model: every live graph holds POOL bytes of CAPACITY, and a first run grows
the allocator by POOL. Each query's rows are held against a Session
without the compiled pipeline.
"""

import itertools

import pytest
import torch

from query_engine_tpu_torch.engine.session import Session
from torch_graph_stand_in import stand_in_graphs

POOL = 100
CAPACITY = 350  # three pools fit, a fourth does not
QUERIES = [
    "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k",
    "SELECT k, COUNT(*) AS c FROM t WHERE v > 3 GROUP BY k ORDER BY k",
    "SELECT SUM(v * 2) AS s FROM t",
    "SELECT k, MAX(v) AS m FROM t GROUP BY k ORDER BY k",
    "SELECT k, MIN(v) AS m, AVG(v) AS a FROM t GROUP BY k ORDER BY k",
    # a scattered result (the filter's holes), compacted after the program
    "SELECT k, v FROM t WHERE v > 190",
]
TABLE = {"k": [i % 5 for i in range(200)], "v": list(range(200))}


def _session(compiled=True):
    s = Session(device="cpu")
    s.register_table("t", TABLE)
    s.executor._compiled = compiled
    return s


@pytest.fixture()
def modelled():
    """(session, pipeline, {query: its cache key}) with the stand-in graphs
    and the memory model."""
    s = _session()
    pipe = s.executor.pipeline
    stand_in_graphs(pipe)
    capture = pipe._capture

    def capture_with_pool(entry, *args):
        capture(entry, *args)
        entry.need = POOL

    pipe._capture = capture_with_pool
    pipe._free_bytes = lambda: CAPACITY - POOL * sum(
        e.graph is not None for e in pipe._cache.values())
    grown = itertools.count(0, POOL)  # base, then base + POOL
    pipe._reserved_bytes = lambda: next(grown)
    return s, pipe, {}


def _run(s, pipe, keys, q, want):
    before = set(pipe._cache)
    rows = s.sql(QUERIES[q]).to_pylist()
    assert rows == want[q]
    new = set(pipe._cache) - before
    if new:
        (keys[q],) = new
    return rows


def _live(pipe, keys):
    return sorted(q for q, k in keys.items()
                  if pipe._cache[k].graph is not None)


@pytest.fixture(scope="module")
def want():
    s = _session(compiled=False)
    return [s.sql(q).to_pylist() for q in QUERIES]


def test_lru_graphs_released_for_a_capture_that_does_not_fit(modelled, want):
    s, pipe, keys = modelled
    for q in range(3):
        _run(s, pipe, keys, q, want)
    assert _live(pipe, keys) == [0, 1, 2]
    assert pipe.stats["graphs_released"] == 0
    _run(s, pipe, keys, 3, want)  # 50 free, 112 needed: query 0's goes
    assert _live(pipe, keys) == [1, 2, 3]
    assert pipe.stats["graphs_released"] == 1
    _run(s, pipe, keys, 1, want)  # a replay: query 1 is now the newest
    assert pipe.stats["replays"] == 1
    captures = pipe.stats["captures"]
    _run(s, pipe, keys, 0, want)  # captures again, releasing query 2's
    assert pipe.stats["captures"] == captures + 1
    assert _live(pipe, keys) == [0, 1, 3]
    assert pipe.stats["graphs_released"] == 2
    assert pipe.stats["compiles"] == 4
    for q in (0, 1, 3, 0):  # replays of the live graphs give their rows
        _run(s, pipe, keys, q, want)
    assert _live(pipe, keys) == [0, 1, 3]


def test_room_made_before_a_first_run(modelled, want):
    """A first run's eager body runs with room for as much as any program
    has taken: the LRU graph goes before the body, not after it."""
    s, pipe, keys = modelled
    for q in range(3):
        _run(s, pipe, keys, q, want)
    body, seen = pipe._body, []

    def body_seeing_graphs(*args):
        if not seen:
            seen.append(sum(e.graph is not None
                            for e in pipe._cache.values()))
        return body(*args)

    pipe._body = body_seeing_graphs
    _run(s, pipe, keys, 3, want)
    assert seen == [2]  # query 0's graph released before the eager body
    assert _live(pipe, keys) == [1, 2, 3]
    assert pipe.stats["graphs_released"] == 1


def test_capture_that_fits_releases_nothing(modelled, want):
    s, pipe, keys = modelled
    for q in (0, 1, 2, 0, 1, 2):
        _run(s, pipe, keys, q, want)
    assert _live(pipe, keys) == [0, 1, 2]
    assert pipe.stats["graphs_released"] == 0
    assert pipe.stats["replays"] == 3


def test_out_of_memory_releases_every_graph_and_runs_again(modelled, want):
    s, pipe, keys = modelled
    for q in range(3):
        _run(s, pipe, keys, q, want)
    body, raised = pipe._body, []

    def body_once_out_of_memory(*args):
        if not raised:
            raised.append(1)
            raise torch.OutOfMemoryError("modelled: out of device memory")
        return body(*args)

    pipe._body = body_once_out_of_memory
    _run(s, pipe, keys, 4, want)
    assert raised and pipe.stats["oom_retries"] == 1
    assert _live(pipe, keys) == [4]
    assert pipe.stats["graphs_released"] == 3
    pipe._body = body
    for q in range(3):  # the released entries capture again
        _run(s, pipe, keys, q, want)
    assert pipe.stats["compiles"] == 4


def test_out_of_memory_with_no_graph_to_release_raises(modelled, want):
    s, pipe, _ = modelled

    def body(*args):
        raise torch.OutOfMemoryError("modelled: out of device memory")

    pipe._body = body
    with pytest.raises(torch.OutOfMemoryError):
        s.sql(QUERIES[0]).to_pylist()
    assert pipe.stats["oom_retries"] == 0


def test_room_for_a_scattered_result(modelled, want):
    """The caller compacts a scattered result while the graph's pool and the
    first run's outputs are held, so its capture's room adds the bytes of
    the outputs (here more than the modelled card holds: every other graph
    goes first); a dense result adds none."""
    s, pipe, keys = modelled
    for q in range(3):
        _run(s, pipe, keys, q, want)
    assert [pipe._cache[keys[q]].result_bytes for q in range(3)] == [0] * 3
    _run(s, pipe, keys, 5, want)
    assert pipe._cache[keys[5]].result_bytes > CAPACITY
    assert pipe.stats["graphs_released"] == 3
    assert _live(pipe, keys) == [5]
