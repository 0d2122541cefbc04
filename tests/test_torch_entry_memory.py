"""What the compiled pipeline's cached programs hold between queries, on
the CPU.

A cached entry keeps its inputs' static facts (schema, capacity, each
column's dtype, dictionary and bounds) and its plan with the eager leaves
stood in for, never an input's planes: between queries only a live graph
holds the planes it reads (`entry.planes`, `entry.xfer`), and a released
entry holds no tensor at all. The graphs are
`tests/torch_graph_stand_in.py`'s; "no graph" is the pipeline admitting
nodes as on CUDA with its capture stubbed out, so the same eager leaves
run and nothing is captured. Each query's rows are held against a Session
without the compiled pipeline. Also the chunked aggregate's staging
planes, which go with the graph that reads them.
"""

import gc
import weakref

import pytest
import torch

from query_engine_tpu_torch.engine import pipeline as P
from query_engine_tpu_torch.engine.session import Session

from torch_graph_stand_in import stand_in_graphs

T = {"k": [i % 7 for i in range(300)],
     "v": [float(i % 23) for i in range(300)],
     "s": [("alpha", "beta", "gamma", "delta")[i % 4] for i in range(300)]}
U = {"k": list(range(7)),
     "name": ["ant", "bee", "asp", "cat", "auk", "dog", "ape"]}
# the LIKE filter over u runs as an eager leaf where the pipeline admits
# nodes as on CUDA; the scalar subquery's batch is a program input
QUERY = ("SELECT t.k, COUNT(*) AS c, SUM(t.v) AS s FROM t "
         "JOIN (SELECT k FROM u WHERE name LIKE 'a%') a ON t.k = a.k "
         "WHERE t.v > (SELECT AVG(v) FROM t) GROUP BY t.k ORDER BY t.k")


def _session(mode):
    s = Session(device="cpu")
    s.register_table("t", T)
    s.register_table("u", U)
    pipe = s.executor.pipeline
    if mode == "graphs":
        stand_in_graphs(pipe)
    elif mode == "no_graph":
        pipe._graphs = True
        pipe._capture = lambda *args: None
    else:
        s.executor._compiled = False
    return s, pipe


@pytest.fixture(scope="module")
def want():
    s, _ = _session("eager")
    return s.sql(QUERY).to_pylist()


def _spy_inputs(pipe):
    """Weak references to the planes of every eager leaf's and subquery's
    batch the pipeline materializes, by kind."""
    refs = {}
    real = pipe._materialize_leaf

    def spy(node, kind=None):
        b = real(node, kind)
        if b is not None and not isinstance(node, P.pp.PScan):
            refs.setdefault(kind or type(node).__name__[1:], []).extend(
                weakref.ref(t) for c in b.columns
                for t in (c.data, c.validity))
        return b

    pipe._materialize_leaf = spy
    return refs


def _tensors(obj, seen=None):
    """The tensors reachable from `obj` through containers and the
    pipeline's own objects, a table source's (its planes) left out."""
    seen = set() if seen is None else seen
    if id(obj) in seen or hasattr(obj, "_batch"):
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        kids = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        kids = list(obj)
    elif type(obj).__module__.startswith("query_engine_tpu_torch"):
        kids = gc.get_referents(obj)
    else:
        return []
    return [t for k in kids for t in _tensors(k, seen)]


def _alive(refs):
    gc.collect()
    return [r for rs in refs.values() for r in rs if r() is not None]


def test_inputs_held_only_by_the_live_graph(want):
    s, pipe = _session("graphs")
    refs = _spy_inputs(pipe)
    assert s.sql(QUERY).to_pylist() == want
    assert set(refs) == {"Filter", "subplan"}, set(refs)
    alive = _alive(refs)
    assert alive
    # each input plane still alive is one a live graph reads
    read = {id(t) for e in pipe._cache.values() if e.graph is not None
            for pl in e.planes for dv in pl for t in dv}
    assert all(id(r()) in read for r in alive)
    # and nothing else of an entry reaches a tensor
    for e in pipe._cache.values():
        held = {id(t) for t in _tensors([getattr(e, f) for f in e.__slots__
                                         if f not in ("outputs", "planes",
                                                      "xfer", "n_bufs",
                                                      "dyn_bufs")])}
        assert not held & {id(r()) for r in alive}
    assert pipe.release_graphs() == len(pipe._cache)
    assert not _alive(refs)
    for e in pipe._cache.values():
        assert e.released and not _tensors(e)


def test_inputs_die_with_the_query_without_a_graph(want):
    s, pipe = _session("no_graph")
    refs = _spy_inputs(pipe)
    assert s.sql(QUERY).to_pylist() == want
    assert set(refs) == {"Filter", "subplan"} and not _alive(refs)
    assert pipe.stats["captures"] == 0
    for e in pipe._cache.values():
        assert not _tensors([e.leaf_facts, e.sub_facts, e.plan])


def test_a_released_entry_captures_again(want):
    s, pipe = _session("graphs")
    assert s.sql(QUERY).to_pylist() == want
    st = dict(pipe.stats)
    assert s.sql(QUERY).to_pylist() == want
    warm = {k: pipe.stats[k] - st[k] for k in ("captures", "replays")}
    n = pipe.release_graphs()
    assert n and all(e.graph is None for e in pipe._cache.values())
    st = dict(pipe.stats)
    assert s.sql(QUERY).to_pylist() == want
    # every released entry captures once (one reading an eager leaf's new
    # batch would have anyway)
    assert pipe.stats["captures"] - st["captures"] == n
    assert pipe.stats["compiles"] == st["compiles"]
    assert all(e.graph is not None for e in pipe._cache.values())
    st = dict(pipe.stats)
    assert s.sql(QUERY).to_pylist() == want
    assert {k: pipe.stats[k] - st[k] for k in warm} == warm


def test_equal_dictionaries_key_two_entries():
    """Two tables whose string columns hold the same values in two
    dictionary objects: the program over each is its own entry, and each
    entry keeps its table's dictionary (the id it is keyed on) alive."""
    s, pipe = _session("graphs")
    s.register_table("t2", T)
    d1 = s.sources["t"]._batch.columns[2].dictionary
    d2 = s.sources["t2"]._batch.columns[2].dictionary
    assert d1 is not d2 and list(d1.values) == list(d2.values)
    q = "SELECT s, COUNT(*) AS c, SUM(v) AS x FROM {} GROUP BY s ORDER BY s"
    rows = [s.sql(q.format(n)).to_pylist() for n in ("t", "t2")]
    assert rows[0] == rows[1] == _session("eager")[0].sql(
        q.format("t")).to_pylist()
    assert len(pipe._cache) == 2
    kept = [[dic for _, dic in f.types if dic is not None]
            for e in pipe._cache.values() for f in e.leaf_facts]
    assert sorted(map(id, sum(kept, []))) == sorted((id(d1), id(d2)))
    pipe.release_graphs()
    gc.collect()
    rows2 = [s.sql(q.format(n)).to_pylist() for n in ("t", "t2")]
    assert rows2 == rows and len(pipe._cache) == 2


def test_chunk_staging_goes_with_its_graph(monkeypatch):
    monkeypatch.setenv("QE_CHUNK_ENGAGE", "1024")
    monkeypatch.setenv("QE_CHUNK_ROWS", "512")
    fact = {"k": [i % 9 for i in range(5000)],
            "v": [(i * 7) % 101 for i in range(5000)]}
    query = "SELECT k, COUNT(*) AS c, SUM(v) AS s FROM fact GROUP BY k " \
            "ORDER BY k"
    plain = Session(device="cpu")
    plain.register_table("fact", fact)
    plain.executor._compiled = False
    want = plain.sql(query).to_pylist()

    s = Session(device="cpu")
    s.register_table("fact", fact)
    pipe = s.executor.pipeline
    stand_in_graphs(pipe)
    agg = s.executor.chunked
    assert s.sql(query).to_pylist() == want
    (planes,) = agg._staging.values()
    refs = [weakref.ref(t) for dv in planes for t in dv]
    del planes
    captures = agg.stats["captures"]
    assert s.sql(query).to_pylist() == want
    assert agg.stats["captures"] == captures  # replayed over the same planes
    pipe.release_graphs()
    gc.collect()
    assert not agg._staging and all(r() is None for r in refs)
    assert s.sql(query).to_pylist() == want
    assert len(agg._staging) == 1
    assert agg.stats["captures"] == captures + 1
