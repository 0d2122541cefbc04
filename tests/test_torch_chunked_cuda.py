"""The chunked aggregate on the card (`engine/chunked.py`), held against
the unchunked card Session and a CPU Session on the same data. Each test
skips without a CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_chunked_cuda.py -m cuda

* chunked results equal the unchunked card Session's and the CPU
  Session's (integers exactly, floats to rtol 1e-9), for grouped and
  global aggregates, an FK join below the aggregate, NULL keys and values,
  and operators above the aggregate;
* the first chunked query captures the partial program once and replays
  it for the other chunks; a warm chunked query makes no new capture and
  one replay a chunk, and gives the same rows;
* the staging planes stay where they were from query to query, and the
  group_agg kernel launches in a chunked GROUP BY.
"""

import math

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import group_agg

pytestmark = pytest.mark.cuda

RTOL = 1e-9
N = 50_000
ENGAGE, ROWS = 1 << 14, 1 << 12
CHUNKS = -(-N // ROWS)


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _tables(seed=23):
    rng = np.random.default_rng(seed)
    fact = {"k": rng.integers(0, 40, N).tolist(),
            "v": rng.integers(1, 1000, N).tolist(),
            "f": rng.normal(10, 3, N).round(4).tolist()}
    for i in range(0, N, 77):
        fact["v"][i] = None
    for i in range(0, N, 53):
        fact["k"][i] = None
    dim = {"d_id": list(range(40)), "w": rng.integers(0, 100, 40).tolist(),
           "r": (rng.integers(128, 384, 40) / 256).tolist()}
    return fact, dim


FACT, DIM = _tables()
CASES = [
    "SELECT k, COUNT(*) AS c, SUM(v) AS s FROM fact GROUP BY k "
    "ORDER BY k NULLS LAST",
    "SELECT k, SUM(v) AS s FROM fact GROUP BY k HAVING COUNT(*) > 10 "
    "ORDER BY s DESC LIMIT 7",
    "SELECT f.k, COUNT(f.v) AS n, AVG(f.v) AS a, MIN(d.w) AS lo, "
    "MAX(f.v) AS hi, SUM(f.v * d.r) AS s FROM fact f JOIN dim d "
    "ON f.k = d.d_id WHERE f.v > 50 GROUP BY f.k ORDER BY f.k",
    "SELECT k, SUM(f) AS s, AVG(f) AS a FROM fact GROUP BY k "
    "ORDER BY k NULLS LAST",
    "SELECT COUNT(*), SUM(v), AVG(f), MIN(f), MAX(v) FROM fact",
]


def _session(device):
    s = Session(device=device)
    s.register_table("fact", FACT)
    s.register_table("dim", DIM)
    return s


def _same(got, want):
    assert len(got) == len(want), (got[:3], want[:3])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


@pytest.fixture(scope="module")
def plain_rows():
    if not torch.cuda.is_available():  # runs before the autouse fixture
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    cpu = _session("cpu")
    card = _session("cuda")
    out = {}
    for sql in CASES:
        out[sql] = (cpu.sql(sql).to_pylist(), card.sql(sql).to_pylist())
        assert card.executor.chunked.stats["queries"] == 0
    return out


@pytest.mark.parametrize("sql", CASES)
def test_chunked_equals_unchunked_on_the_card(sql, plain_rows, monkeypatch):
    monkeypatch.setenv("QE_CHUNK_ENGAGE", str(ENGAGE))
    monkeypatch.setenv("QE_CHUNK_ROWS", str(ROWS))
    s = _session("cuda")
    st = s.executor.chunked.stats
    cpu_rows, card_rows = plain_rows[sql]
    group_agg.launches = 0
    first = s.sql(sql).to_pylist()
    assert st["queries"] == 1 and st["chunks"] == CHUNKS
    assert st["captures"] == 1 and st["replays"] == CHUNKS - 1
    if "GROUP BY" in sql:  # a global aggregate takes no group_agg route
        assert group_agg.launches > 0
    _same(first, card_rows)
    _same(first, cpu_rows)
    before = dict(st)
    warm = s.sql(sql).to_pylist()
    assert st["captures"] == before["captures"]
    assert st["replays"] - before["replays"] == CHUNKS
    _same(warm, cpu_rows)


def test_staging_planes_stay_put(monkeypatch):
    monkeypatch.setenv("QE_CHUNK_ENGAGE", str(ENGAGE))
    monkeypatch.setenv("QE_CHUNK_ROWS", str(ROWS))
    s = _session("cuda")
    agg = s.executor.chunked
    s.sql(CASES[0])
    ptrs = [(d.data_ptr(), v.data_ptr())
            for planes in agg._staging.values() for d, v in planes]
    s.sql(CASES[2])
    s.sql(CASES[0])
    after = [(d.data_ptr(), v.data_ptr())
             for planes in agg._staging.values() for d, v in planes]
    assert after[:len(ptrs)] == ptrs
    assert all(d.is_cuda for planes in agg._staging.values()
               for d, _ in planes)
