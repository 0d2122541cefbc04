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
from query_engine_tpu_torch.ops import agg_variants as AV
from query_engine_tpu_torch.ops import group_agg, small_gather
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.tpch import data as tpch_data
from query_engine_tpu_torch.tpch import oracle as tpch_oracle
from query_engine_tpu_torch.tpch import queries as tpch_queries

pytestmark = pytest.mark.cuda

BENCH_QUERY = (
    "SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
    "FROM f JOIN d ON f.dept = d.dept_id "
    "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10"
)
# the small-table gather's query: a float dimension column
QUERY_B = (
    "SELECT f.dept, COUNT(*) AS c, SUM(f.salary * d.rate) AS s "
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


@pytest.mark.parametrize("n,T,W", [(1 << 16, 1024, 1), (1 << 16, 4096, 3),
                                   (1000, 1, 1), (5000, 300, 20),
                                   (777, 4096, 17)])
def test_small_gather_kernel_matches_plain(cuda_device, n, T, W):
    """Bit-exact against the plain version, out-of-range indices included;
    (4096, 17) exceeds a block's shared memory: the device-memory path."""
    rng = np.random.default_rng(n + T + W)
    table = rng.integers(-(2**31), 2**31, (T, W)).astype(np.int32)
    idx = rng.integers(-1, T + 1, n).astype(np.int32)
    idx[:4] = [-(2**31), 2**31 - 1, T, -1]
    ti = torch.from_numpy(idx).to(cuda_device)
    tt = torch.from_numpy(table).to(cuda_device)
    before = small_gather.launches
    got = small_gather.gather_words(ti, tt)
    torch.cuda.synchronize()
    assert small_gather.launches == before + 1
    assert got.is_cuda and got.dtype == torch.int32 and got.shape == (n, W)
    assert torch.equal(got, small_gather.gather_words_plain(ti, tt))


def _bench_sessions(device, n, seed, mxu_gather, monkeypatch):
    rng = np.random.default_rng(seed)
    f = {"age": rng.integers(18, 65, n),
         "salary": rng.integers(50_000, 150_000, n),
         "dept": rng.integers(0, 1024, n)}
    d = {"dept_id": np.arange(1024), "bonus": rng.integers(0, 1000, 1024),
         "rate": rng.integers(128, 384, 1024) / 256}
    monkeypatch.setenv("QE_MXU_GATHER", mxu_gather)
    cpu, gpu = Session("cpu"), Session(device)
    for s in (cpu, gpu):
        s.register_table("f", ColumnBatch.from_pydict(f))
        s.register_table("d", ColumnBatch.from_pydict(d))
    return cpu, gpu


@pytest.mark.parametrize("mxu_gather", ["0", "1"])
@pytest.mark.parametrize("query", [BENCH_QUERY, QUERY_B])
def test_compiled_queries_on_card_match_cpu(cuda_device, monkeypatch,
                                            mxu_gather, query):
    """Queries A and B through the captured program: the first run compiles
    and captures, the second replays; both equal the CPU port's rows."""
    cpu, gpu = _bench_sessions(cuda_device, 30_000, 3, mxu_gather,
                               monkeypatch)
    want = cpu.sql(query).to_pylist()
    gathers = small_gather.launches
    assert gpu.sql(query).to_pylist() == want
    st = gpu.executor.pipeline.stats
    assert st["compiles"] == 1 and st["captures"] == 1, st
    syncs = gpu.executor.host_syncs
    assert gpu.sql(query).to_pylist() == want
    assert st["replays"] == 1 and gpu.executor.host_syncs == syncs + 1, st
    # Query A's dimension is Query B's here, so both take the lookup route
    assert (small_gather.launches > gathers) == (mxu_gather == "1")


def test_replay_after_reregistering_a_table(cuda_device):
    """A table registered anew at the same capacity: the graph is captured
    over the new planes, and the rows are the new table's."""
    s = Session(cuda_device)
    q = "SELECT x, y FROM t WHERE y >= 20 ORDER BY x DESC"
    s.register_table("t", {"x": [1, 2, 3], "y": [10, 20, 30]})
    assert s.sql(q).to_pylist() == [(3, 30), (2, 20)]
    assert s.sql(q).to_pylist() == [(3, 30), (2, 20)]  # a replay
    s.register_table("t", {"x": [1, 2, 3, 4], "y": [10, 20, 30, 40]})
    assert s.sql(q).to_pylist() == [(4, 40), (3, 30), (2, 20)]
    st = s.executor.pipeline.stats
    assert st["compiles"] == 1 and st["captures"] == 2, st
    assert st["replays"] == 2, st


def test_one_captured_program_for_many_literal_values(cuda_device):
    """A literal is a program input: each replay reads the value written
    into its buffer, and a non-dense result is compacted after the replay."""
    s = Session(cuda_device)
    s.register_table("t", {"x": list(range(10)), "y": [3 * i for i in
                                                       range(10)]})
    for v, want in ((20, [9, 8, 7]), (10, [9, 8, 7, 6, 5, 4]), (26, [9])):
        got = s.sql(f"SELECT x FROM t WHERE y > {v} ORDER BY x DESC")
        assert got.to_pylist() == [(x,) for x in want]
        assert s.sql(f"SELECT x, y FROM t WHERE y > {v}").to_pylist() == [
            (x, 3 * x) for x in sorted(want)]
    st = s.executor.pipeline.stats
    assert st["compiles"] == 2 and st["captures"] == 2, st
    assert st["replays"] == 4, st


def test_string_nodes_run_eagerly_on_card(cuda_device):
    """String comparisons and string join keys remap dictionary codes
    through host tables, which a graph cannot capture: those nodes run in
    the eager executor on the card, the rest of the query compiled."""
    f = {"k": ["a", "b", "c", "a", None], "v": [1, 2, 3, 4, 5]}
    d = {"k": ["a", "b", "c"], "w": [10, 20, 30]}
    cpu, gpu = Session("cpu"), Session(cuda_device)
    for s in (cpu, gpu):
        s.register_table("f", f)
        s.register_table("d", d)
    for q in ("SELECT v FROM f WHERE k > 'a' ORDER BY v DESC",
              "SELECT f.v, d.w FROM f JOIN d ON f.k = d.k ORDER BY f.v"):
        want = cpu.sql(q).to_pylist()
        assert gpu.sql(q).to_pylist() == want
        assert gpu.sql(q).to_pylist() == want
    assert gpu.executor.pipeline.stats["compiles"] >= 1


def _agg_inputs(n, case, device):
    """"dense": all 1024 groups and every chunk lane (values over the full
    int64 range); "sparse": a few groups, most gid -1, values near +-2^63."""
    rng = np.random.default_rng(n + len(case))
    values = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64,
                          endpoint=True)
    ok = rng.random(n) < 0.97
    if case == "dense":
        gid = rng.integers(0, 1024, n).astype(np.int32)
        gid[rng.random(n) < 0.02] = -1
        gid[rng.random(n) < 0.01] = 1024 + rng.integers(0, 500)
    else:
        gid = np.full(n, -1, np.int32)
        few = rng.random(n) < 0.01
        gid[few] = rng.choice([0, 1, 127, 128, 511, 1000, 1023], few.sum())
        values = np.where(rng.random(n) < 0.5, 2**63 - 1 - values % 1000,
                          -(2**63) + values % 1000)
    values[:2] = [-(2**63), 2**63 - 1]
    return tuple(torch.from_numpy(a).to(device) for a in (values, ok, gid))


@pytest.mark.parametrize("case", ["dense", "sparse"])
@pytest.mark.parametrize("variant,num_groups", [
    ("v1", 1024), ("v2", 1024), ("v4", 1024), ("v5", 1024), ("s8", 1024),
    ("s8", 1000)])
def test_onehot_kernel_chunk_totals_match_plain(cuda_device, variant,
                                                num_groups, case):
    """Each one-hot tensor-core kernel's chunk totals equal its plain
    version's bit for bit at 2^20 + 5 rows (a ragged tail), and two launches
    give identical bits."""
    values, ok, gid = _agg_inputs((1 << 20) + 5, case, cuda_device)
    vlo, vhi, gid_m = AV.prepare(values, ok, gid)
    before = AV.launches[variant]
    got = AV.chunk_totals(variant, vlo, vhi, gid_m, num_groups)
    again = AV.chunk_totals(variant, vlo, vhi, gid_m, num_groups)
    torch.cuda.synchronize()
    assert AV.launches[variant] == before + 2
    want = AV.chunk_totals_plain(variant, vlo, vhi, gid_m, num_groups)
    assert got.is_cuda and got.shape == (num_groups, AV.LANES[variant])
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    sums, counts = AV.recombine(variant, got)
    v0_s, v0_c = group_agg.grouped_sum_count(values, ok, gid, num_groups)
    assert torch.equal(sums, v0_s) and torch.equal(counts, v0_c)


@pytest.fixture(scope="module")
def tpch_sessions():
    """The TPC-H tables at 2^14 lineitem rows in a CPU and a CUDA Session."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    tables = tpch_data.generate(1 << 14)
    cpu, gpu = Session("cpu"), Session("cuda")
    for s in (cpu, gpu):
        tpch_data.register(s, tables)
    return tables, cpu, gpu


@pytest.mark.parametrize("q", list(tpch_queries.QUERIES))
def test_tpch_query_on_card_matches_cpu(tpch_sessions, q):
    """Each of the twelve queries on the card (first run, then a replay)
    equals the CPU port's rows: integers, strings and dates exactly, floats
    to rtol 1e-9 (fixed-point sums on the card)."""
    _, cpu, gpu = tpch_sessions
    text = tpch_queries.QUERIES[q]
    want = cpu.sql(text).to_pylist()
    keys = tpch_oracle.FLOAT_SORT_KEYS.get(q, ())
    for _ in range(2):
        tpch_oracle.compare(gpu.sql(text).to_pylist(), want, keys)


@pytest.mark.parametrize("q", list(tpch_queries.SHIFTED))
def test_tpch_shifted_literals_on_card(tpch_sessions, q):
    """The shifted date literals replay the program with the new dates."""
    tables, _, gpu = tpch_sessions
    gpu.sql(tpch_queries.QUERIES[q]).to_pylist()
    got = gpu.sql(tpch_queries.SHIFTED[q]).to_pylist()
    tpch_oracle.compare(got, tpch_oracle.shifted(tables)[q])
