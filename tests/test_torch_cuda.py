"""Tests of the port that need a CUDA GPU; each skips without one.

This file imports neither jax nor the JAX package, so it also runs where
JAX is not installed. On the card, from the root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_cuda.py -m cuda

(--noconftest skips tests/conftest.py, which sets up JAX for the other
tests.)
"""

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

BENCH_QUERY = (
    "SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
    "FROM f JOIN d ON f.dept = d.dept_id "
    "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10"
)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _items(n, G, seed, device):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G, n).astype(np.int32)
    gid[rng.random(n) < 0.05] = -1
    x = rng.normal(0.0, 1e7, n)
    x[:3] = [np.inf, -np.inf, np.nan]
    items = [
        (rng.integers(-(1 << 62), 1 << 62, n), rng.random(n) > 0.15),
        (x, rng.random(n) > 0.25),
        (np.ones(n, np.int64), np.ones(n, bool)),
    ]
    t = [(torch.from_numpy(v).to(device), torch.from_numpy(ok).to(device))
         for v, ok in items]
    return torch.from_numpy(gid).to(device), t, x


@pytest.mark.parametrize("n,G", [(1 << 16, 7), (1 << 16, 2048),
                                 (1 << 16, 32768), (100, 5)])
def test_kernel_matches_plain_and_repeats_bits(cuda_device, n, G):
    """Shared-memory (small G) and device-memory (G = 32768) paths. Ints
    exact; floats to rtol 1e-9, atol max|x| * 1e-9 (fixed point against
    float64 summation); two launches give identical bits."""
    gid, items, x = _items(n, G, n + G, cuda_device)
    before = group_agg.launches
    got = group_agg.grouped_sums_counts_multi(items, gid, G)
    again = group_agg.grouped_sums_counts_multi(items, gid, G)
    assert group_agg.launches == before + 2
    want = group_agg.grouped_sums_counts_multi_plain(items, gid, G)
    atol = np.abs(x[np.isfinite(x)]).max() * 1e-9
    for (s, c), (s2, c2), (ws, wc) in zip(got, again, want):
        assert s.is_cuda and c.is_cuda
        assert torch.equal(c, c2)
        assert torch.equal(s.view(torch.int64), s2.view(torch.int64))
        assert torch.equal(c, wc)
        if s.dtype == torch.int64:
            assert torch.equal(s, ws)
        else:
            np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(),
                                       rtol=1e-9, atol=atol)


def test_float_segment_sum_on_card_is_deterministic(cuda_device):
    """The segment path's float SUM on CUDA (fixed point, int64 adds) gives
    the same bits on every run and agrees with float64 summation."""
    gid, items, x = _items(1 << 16, 40000, 3, cuda_device)
    v, ok = items[1]
    g = gid.to(torch.int64).clamp(min=0)
    a, _ = K.segment_aggregate("sum", v, ok, g, v.shape[0], 40000)
    b, _ = K.segment_aggregate("sum", v, ok, g, v.shape[0], 40000)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    ref, _ = K.segment_aggregate("sum", v.cpu(), ok.cpu(), g.cpu(),
                                 v.shape[0], 40000)
    atol = np.abs(x[np.isfinite(x)]).max() * 1e-9
    np.testing.assert_allclose(a.cpu().numpy(), ref.numpy(), rtol=1e-9,
                               atol=atol)


def test_bench_query_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(7)
    n = 20_000
    f = {"age": rng.integers(18, 65, n),
         "salary": rng.integers(50_000, 150_000, n),
         "dept": rng.integers(0, 1024, n)}
    d = {"dept_id": np.arange(1024), "bonus": rng.integers(0, 1000, 1024)}
    cpu, gpu = Session("cpu"), Session(cuda_device)
    for s in (cpu, gpu):
        s.register_table("f", ColumnBatch.from_pydict(f))
        s.register_table("d", ColumnBatch.from_pydict(d))
    before = group_agg.launches
    out = gpu.sql(BENCH_QUERY)
    assert group_agg.launches > before
    assert all(c.data.is_cuda and c.validity.is_cuda for c in out.columns)
    assert out.to_pylist() == cpu.sql(BENCH_QUERY).to_pylist()
