"""The mesh pipeline on the card: queries through
`Session(mesh=make_mesh(["cuda:0"] * 4))` (four virtual shards of one
card, a host thread each) held against the same queries through a CPU
Session over 4 CPU shards. Each test skips without a CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_mesh_cuda.py -m cuda

Integers and strings equal; floats (partials summed in fixed point by
group_agg on the card) within rtol 1e-9. The mesh stats that count the
paths (compiles, fallbacks, exchanges, overflow retries, joins counted,
partial/final aggregates) equal the CPU mesh's, and the aggregates launch
group_agg on the card.
"""

import math

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.cuda

N_SHARDS = 4
N = 1 << 14
PATH_STATS = ("compiles", "fallbacks", "exchanges", "overflow_retries",
              "joins_counted", "agg_partial_final", "eager_leaves")


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _tables(seed=5):
    rng = np.random.default_rng(seed)
    fact = {
        "id": list(range(N)),
        "k": rng.integers(0, 200, N).tolist(),
        "g": rng.integers(0, 40, N).tolist(),
        "v": rng.integers(-1000, 1000, N).tolist(),
        "x": rng.normal(10, 3, N).round(4).tolist(),
    }
    for i in range(0, N, 53):
        fact["v"][i] = None
    dim = {"k": list(range(200)), "w": rng.integers(0, 50, 200).tolist(),
           "tag": [f"t{i % 7}" for i in range(200)]}
    # both sides repeat every key: no bounded side, a counted join
    rep = {"g": rng.integers(0, 40, 3000).tolist(),
           "u": rng.integers(0, 100, 3000).tolist()}
    return {"fact": fact, "dim": dim, "rep": rep}


@pytest.fixture(scope="module")
def sessions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    tables = _tables()
    out = []
    for dev, mesh in (("cuda", make_mesh(["cuda:0"] * N_SHARDS)),
                      ("cpu", make_mesh(["cpu"] * N_SHARDS))):
        s = Session(device=dev, mesh=mesh)
        for name, t in tables.items():
            s.register_table(name, t)
        out.append(s)
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def _run(sessions, sql):
    card, cpu = sessions
    st = []
    rows = []
    for s in (card, cpu):
        before = dict(s.mesh_pipeline.stats)
        rows.append(s.sql(sql).to_pylist())
        st.append({k: s.mesh_pipeline.stats[k] - before[k]
                   for k in PATH_STATS})
    _same(rows[0], rows[1])
    assert st[0] == st[1], st
    assert st[0]["compiles"] >= 1 and st[0]["fallbacks"] == 0, st
    return rows[0], st[0]


def test_grouped_join_on_the_card(sessions):
    group_agg.launches = 0
    rows, st = _run(
        sessions,
        "SELECT d.tag, COUNT(*) AS c, SUM(f.v + d.w) AS s, AVG(f.x) AS a "
        "FROM fact f JOIN dim d ON f.k = d.k WHERE f.v > -500 "
        "GROUP BY d.tag ORDER BY d.tag")
    assert len(rows) == 7 and st["exchanges"] >= 3
    assert group_agg.launches > 0


def test_counted_join_on_the_card(sessions):
    rows, st = _run(
        sessions,
        "SELECT r.g, COUNT(*) AS c, SUM(f.v) AS s FROM fact f "
        "JOIN rep r ON f.g = r.g GROUP BY r.g ORDER BY r.g")
    assert st["joins_counted"] == 1 and len(rows) == 40


def test_global_sort_on_the_card(sessions):
    rows, _ = _run(
        sessions,
        "SELECT id, v, x FROM fact WHERE v IS NOT NULL "
        "ORDER BY v DESC, id LIMIT 300")
    assert len(rows) == 300


def test_global_window_on_the_card(sessions):
    rows, st = _run(
        sessions,
        "SELECT id, RANK() OVER (ORDER BY g) AS r, "
        "SUM(v) OVER (ORDER BY g) AS rs, "
        "LAG(v, 2) OVER (ORDER BY g, id) AS lg FROM fact "
        "ORDER BY id LIMIT 500")
    # the window ran in the mesh program, not as an eager leaf
    assert len(rows) == 500 and st["eager_leaves"] == 0, st
