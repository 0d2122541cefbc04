"""The mesh path's differential fuzz, port against reference:
tests/test_fuzz_mesh.py's 60 seeds of `gen_query` (tests/
test_fuzz_compiled.py) through the port's Session over 8 CPU shards and
the JAX package's single-device Session, on the same tables
(`make_session`'s draws). Mesh-ineligible shapes fall back inside the
port's Session, so every query must still give the reference's rows: as
multisets where the query does not order them, floats to rtol 1e-9
(partial/final combining reassociates float sums). Every seed whose query
is a join runs in the fast tier with a spread of the other shapes; the
rest are slow.
"""

import math
import random

import pytest

import test_fuzz_compiled as F
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.parallel.mesh import make_mesh

N_QUERIES = 60
JOINS = [5, 10, 19, 24, 26, 27, 33, 37, 38, 42, 53, 58]
OTHERS = [0, 2, 15, 20, 23, 25, 36, 46, 52, 56]
FAST = set(JOINS + OTHERS)
SEEDS = [s if s in FAST else pytest.param(s, marks=pytest.mark.slow)
         for s in range(N_QUERIES)]


def _port_mesh_session():
    """make_session's tables (the same draws) in a port mesh Session."""
    real = F.Session
    F.Session = lambda: Session(device="cpu", mesh=make_mesh(["cpu"] * 8))
    try:
        return F.make_session(True)
    finally:
        F.Session = real


@pytest.fixture(scope="module")
def sessions():
    return _port_mesh_session(), F.make_session(True)


def _cells_match(x, y):
    if isinstance(x, float) and isinstance(y, float):
        if math.isnan(x) and math.isnan(y):
            return True
        return x == pytest.approx(y, rel=1e-9, abs=1e-9)
    return x == y


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_mesh_port_vs_reference(sessions, seed):
    port, ref = sessions
    q, ordered = F.gen_query(random.Random(seed))
    got = port.sql(q)
    want = ref.sql(q)
    assert got.schema.names() == want.schema.names(), q
    rg, rw = got.to_pylist(), want.to_pylist()
    if not ordered:
        rg, rw = sorted(rg, key=F._key), sorted(rw, key=F._key)
    assert len(rg) == len(rw), q
    for x, y in zip(rg, rw):
        assert len(x) == len(y) and all(
            _cells_match(a, b) for a, b in zip(x, y)), f"{q}\n{x}\n{y}"


def test_fuzz_joins_ride_the_mesh(sessions):
    """The fast tier's joins ran as mesh programs (compiled, then hits)."""
    port, _ = sessions
    for seed in JOINS:
        port.sql(F.gen_query(random.Random(seed))[0])
    st = port.mesh_pipeline.stats
    assert st["compiles"] > 0 and st["hits"] > 0, st
