"""The compiled FK join gathers only the build columns its program reads.

`engine/pipeline.py`'s `_demands` works out, once per cached program, which
output columns of each plan node the nodes above it in the same program
read; `_trace_fk_join` gathers just those of its build side and stands a
zero-stride NULL plane in for each other one. Each case runs a fact table
`f` joined to the 10-column dimension `d` (key `dk`, then `c1`..`c9`)
through the port in two modes (compiled, and admitting nodes as on CUDA
under `tests/torch_graph_stand_in.py`'s graphs), twice each: the rows must
equal the eager executor's and the JAX package's, and every run must add
the same counts to `pipeline.stats["fk_cols_gathered"]` and
`["fk_cols_pruned"]`, first run, rerun and replay alike.
"""

import random

import pytest

from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.parallel.mesh import make_mesh

from torch_graph_stand_in import stand_in_graphs

_rng = random.Random(26)
N = 400
# fk 20-23 match no row of d: the LEFT join's unmatched rows
F = {"fk": [_rng.randrange(24) for _ in range(N)], "x": list(range(N)),
     "y": [_rng.randrange(6) for _ in range(N)]}
D = {"dk": list(range(20))}
for _c in range(1, 10):
    D[f"c{_c}"] = [(i * (_c + 2) + _c) % 11 for i in range(20)]
D["c1"][3] = None  # a NULL gathered through the packed word
# d.c9 is the key of a second dimension e (chained FK joins)
E = {"ek": list(range(11)), "name": [f"e{i}" for i in range(11)]}
G = {"z": [1, 2]}
# h.y repeats 20 times a value: past the static emit's multiplicity 16, so
# a join on it takes the count->emit pair of programs
H = {"y": [i % 6 for i in range(120)], "w": list(range(120))}
TABLES = {"f": F, "d": D, "e": E, "g": G, "h": H}

J = "FROM f JOIN d ON f.fk = d.dk"
# name: (query, build columns gathered a statement, pruned a statement)
CASES = {
    # the query reads one of d's ten columns
    "one_column": (f"SELECT f.x, d.c1 {J} ORDER BY f.x", 1, 9),
    # SSB Q1.1's shape: the filter on d is pushed below the join, and only
    # f's columns are summed above it
    "q1_1_shape": (f"SELECT SUM(f.x * f.y) AS revenue {J} "
                   "WHERE d.c4 = 3 AND f.y < 4", 0, 10),
    # a column read only by a LEFT join's residual (c3), beside one read
    # above (c1, NULL where the residual un-matches the pair)
    "left_residual": ("SELECT f.x, d.c1 FROM f LEFT JOIN d "
                      "ON f.fk = d.dk AND d.c3 > 5 ORDER BY f.x", 2, 8),
    # a predicate over both tables, a filter above the join
    "filter_above": (f"SELECT f.x {J} WHERE d.c2 > f.y ORDER BY f.x", 1, 9),
    "group_by_key": (f"SELECT d.c5, SUM(f.x) AS s {J} GROUP BY d.c5 "
                     "ORDER BY d.c5", 1, 9),
    "order_by_key": (f"SELECT f.x {J} ORDER BY d.c6, f.x", 1, 9),
    "having": (f"SELECT f.y, SUM(f.x) AS s {J} GROUP BY f.y "
               "HAVING MAX(d.c7) > 8 ORDER BY f.y", 1, 9),
    "partition_by": (f"SELECT f.x, SUM(f.y) OVER (PARTITION BY d.c8) AS s "
                     f"{J} ORDER BY f.x", 1, 9),
    # d.c9 read only by the next join's key; of e, only its name
    "chained_key": (f"SELECT f.x, e.name {J} JOIN e ON d.c9 = e.ek "
                    "ORDER BY f.x", 2, 10),
    # the join is a program's root whose rows go to an eager CROSS join
    "eager_parent": (f"SELECT f.x, d.c1, g.z {J} CROSS JOIN g "
                     "ORDER BY f.x, g.z", 10, 0),
    # every column read, in the count program and in the emit program
    "count_emit": (f"SELECT * {J} JOIN h ON f.y = h.y "
                   "ORDER BY f.x, h.w", 20, 0),
}
MODES = ["compiled", "graphs"]


def _register(s):
    for name, data in TABLES.items():
        s.register_table(name, data)
    return s


@pytest.fixture(scope="module")
def want():
    """Each case's rows from the JAX package and from the eager executor,
    which must agree."""
    js = _register(JSession())
    eager = _register(Session(device="cpu"))
    eager.executor._compiled = False
    out = {}
    for name, (q, _, _) in CASES.items():
        rows = js.sql(q).to_pylist()
        assert eager.sql(q).to_pylist() == rows, name
        out[name] = rows
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_gathers_what_the_program_reads(case, mode, want):
    q, gathered, pruned = CASES[case]
    s = _register(Session(device="cpu"))
    pipe = s.executor.pipeline
    if mode == "graphs":
        stand_in_graphs(pipe)
    for run in range(2):  # the first run, then a rerun (or a replay)
        before = dict(pipe.stats)
        assert s.sql(q).to_pylist() == want[case], (case, run)
        got = (pipe.stats["fk_cols_gathered"] - before["fk_cols_gathered"],
               pipe.stats["fk_cols_pruned"] - before["fk_cols_pruned"])
        assert got == (gathered, pruned), (case, run)
    assert pipe.stats["compiles"] >= 1


def test_mesh_gathers_every_column(monkeypatch, want):
    """The mesh's local traces pass no demand: each shard's FK join gathers
    all of d's columns, as before, and the rows still agree."""
    widths = []
    gather = K.fk_gather_by_rank

    def spy(datas, *args, **kwargs):
        widths.append(len(datas))
        return gather(datas, *args, **kwargs)

    monkeypatch.setattr(K, "fk_gather_by_rank", spy)
    s = _register(Session(device="cpu", mesh=make_mesh(["cpu"] * 2)))
    q = CASES["group_by_key"][0]
    assert s.sql(q).to_pylist() == want["group_by_key"]
    assert s.mesh_pipeline.stats["compiles"] == 1
    assert widths and set(widths) == {len(D)}
