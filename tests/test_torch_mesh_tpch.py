"""TPC-H through the mesh, the port against the JAX package:
tests/test_tpch_mesh.py's battery at `tpch.data.generate(1 << 11)`.

Each of the 22 queries runs through the JAX Session over an 8-device mesh
(the virtual CPU devices) and the port's Session over 8 CPU shards, on the
same tables (`benchmarks/tpch_mini.build`'s, which `tpch.data` reproduces).
The port's rows must equal the numpy oracle (`tpch/oracle.py`) and the JAX
mesh's rows (floats to rtol 1e-9: partial/final aggregation reassociates
float sums), and the change in its `mesh_pipeline.stats` over the query
must equal the JAX mesh's. Queries the mesh cannot lower fall back inside
both Sessions alike. A fast subset runs in the fast tier; the rest are
slow.
"""

import pytest

from benchmarks import tpch_mini
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import data, oracle, queries
from torch_mesh_diff import jax_mesh, port_mesh, stats_change, stats_of

N_LI = 1 << 11
TABLES = ["customer", "orders", "lineitem", "supplier", "nation", "region",
          "part", "partsupp"]
FAST = ("Q1", "Q3", "Q5", "Q6", "Q10", "Q12", "Q14", "Q18")
CASES = [q if q in FAST else pytest.param(q, marks=pytest.mark.slow)
         for q in sorted(queries.QUERIES, key=lambda q: int(q[1:]))]


@pytest.fixture(scope="module")
def sessions():
    _, batches = tpch_mini.build(N_LI)
    jdist = JSession(mesh=jax_mesh())
    for name, batch in zip(TABLES, batches):
        jdist.register_table(name, batch)
    tables = data.generate(N_LI)
    port = Session(device="cpu", mesh=port_mesh())
    data.register(port, tables)
    return jdist, port, tables


def _cells_match(x, y):
    if isinstance(x, float) and isinstance(y, float):
        return abs(x - y) <= 1e-9 * max(abs(x), abs(y), 1.0)
    return x == y


@pytest.mark.parametrize("q", CASES)
def test_mesh_tpch_port_vs_reference(sessions, q):
    jdist, port, tables = sessions
    text = queries.QUERIES[q]
    j0 = stats_of(jdist)
    want = jdist.sql(text)
    jst = stats_change(j0, stats_of(jdist))
    p0 = stats_of(port)
    got = port.sql(text)
    pst = stats_change(p0, stats_of(port))
    assert got.schema.names() == want.schema.names()
    rg, rw = got.to_pylist(), want.to_pylist()
    assert len(rg) == len(rw), (q, len(rg), len(rw))
    for i, (x, y) in enumerate(zip(rg, rw)):
        assert len(x) == len(y) and all(
            _cells_match(a, b) for a, b in zip(x, y)), (q, i, x, y)
    oracle.compare(rg, oracle.run(q, tables),
                   oracle.FLOAT_SORT_KEYS.get(q, ()))
    assert pst == jst, f"{q}: mesh stats\nport {pst}\njax  {jst}"
    # every one of the 22 lowers to a mesh program, as in the reference
    assert pst["compiles"] + pst["hits"] >= 1, (q, pst)
