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
# the small-table gather's query: a float dimension column read beside a
# packed one
QUERY_B = (
    "SELECT f.dept, COUNT(*) AS c, SUM(f.salary * d.rate + d.bonus) AS s "
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
    exact; floats to rtol 1e-9, atol max|x| * 1e-9 against float64
    summation, and bit for bit against the kernel's plain version; two
    launches give identical bits."""
    gid, items, x = _items(n, G, n + G, cuda_device)
    before = group_agg.launches
    got = group_agg.grouped_sums_counts_multi(items, gid, G)
    again = group_agg.grouped_sums_counts_multi(items, gid, G)
    assert group_agg.launches == before + 2
    want = group_agg.grouped_sums_counts_multi_plain(items, gid, G)
    same = group_agg.fixed_point(items, gid, G, group_agg.accumulate_plain)
    atol = np.abs(x[np.isfinite(x)]).max() * 1e-9
    for (s, c), (s2, c2), (ws, wc), (ps, pc) in zip(got, again, want, same):
        assert s.is_cuda and c.is_cuda
        assert torch.equal(c, c2)
        assert torch.equal(s.view(torch.int64), s2.view(torch.int64))
        assert torch.equal(c, wc) and torch.equal(c, pc)
        assert torch.equal(s.view(torch.int64), ps.view(torch.int64))
        if s.dtype == torch.int64:
            assert torch.equal(s, ws)
        else:
            np.testing.assert_allclose(s.cpu().numpy(), ws.cpu().numpy(),
                                       rtol=1e-9, atol=atol)


def _engine_case(case, n, device):
    """(gid, items, G) at the shapes the engine gives the kernel: count-only,
    int64, int32, float64 with +-inf and NaN, float32 items."""
    rng = np.random.default_rng(n + len(case))
    G = 2048
    gid = rng.integers(0, G, n)
    if case == "Q1":  # 4 of 128 slots
        G, gid = 128, rng.integers(0, 4, n)
    elif case == "sorted runs":  # Q3's ids follow row order in short runs
        gid = np.repeat(np.arange(n), rng.integers(1, 8, n))[:n]
        G = int(gid.max()) + 1
    elif case == "2^23 slots, 175 live":  # Q9
        G, gid = 1 << 23, rng.integers(0, 175, n)
    elif case == "one group":  # a global aggregate
        gid = np.zeros(n, np.int64)
    gid[rng.random(n) < 0.03] = -1
    x = rng.normal(0.0, 1e5, n)
    x[rng.permutation(n)[:6]] = [np.inf, np.inf, -np.inf, -np.inf, np.nan,
                                 1e300]
    items = [
        (None, rng.random(n) < 0.9),
        (rng.integers(-(2**62), 2**62, n), rng.random(n) < 0.8),
        (rng.integers(-(2**31), 2**31, n).astype(np.int32),
         rng.random(n) < 0.7),
        (x, rng.random(n) < 0.85),
        (rng.normal(0, 3, n).astype(np.float32), rng.random(n) < 0.6),
    ]
    t = [(None if v is None else torch.from_numpy(v).to(device),
          torch.from_numpy(ok).to(device)) for v, ok in items]
    return torch.from_numpy(gid).to(device), t, G


@pytest.mark.parametrize("gid_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["uniform", "Q1", "sorted runs",
                                  "2^23 slots, 175 live", "one group"])
def test_kernel_rows_equal_plain_contract(cuda_device, case, gid_dtype):
    """The kernel's [R, G] rows and inverse scales equal `accumulate_plain`
    bit for bit: warp aggregation (few groups, sorted runs, one group), the
    shared table and the device-memory groups past it (2^23 slots)."""
    gid, items, G = _engine_case(case, (1 << 18) + 7, cuda_device)
    gid = gid.to(gid_dtype)
    rows, inv = group_agg.accumulate_kernel(items, gid, G)
    rows2, inv2 = group_agg.accumulate_kernel(items, gid, G)
    want, want_inv = group_agg.accumulate_plain(items, gid, G)
    assert torch.equal(rows, want) and torch.equal(rows, rows2)
    assert torch.equal(inv, want_inv) and torch.equal(inv, inv2)


def test_kernel_takes_views_at_any_offset(cuda_device):
    """Views that start off a 16-byte boundary (and a ragged tail) give the
    plain version's rows: the wrapper realigns what the 16-byte loads
    cannot read."""
    n = (1 << 16) + 9
    gid, items, G = _engine_case("uniform", n, cuda_device)
    gid = gid[1:n - 8]
    items = [(None if v is None else v[3:n - 6], ok[5:n - 4])
             for v, ok in items]
    rows, inv = group_agg.accumulate_kernel(items, gid, G)
    want, want_inv = group_agg.accumulate_plain(items, gid, G)
    assert torch.equal(rows, want) and torch.equal(inv, want_inv)


def test_more_items_than_one_launch_takes(cuda_device):
    """18 items: two launches (16 descriptors each at most) write their rows
    and scales in order."""
    gid, items, G = _engine_case("Q1", (1 << 16) + 3, cuda_device)
    items = (items * 4)[:18]
    before = group_agg.launches
    rows, inv = group_agg.accumulate_kernel(items, gid, G)
    assert group_agg.launches == before + 2
    want, want_inv = group_agg.accumulate_plain(items, gid, G)
    assert torch.equal(rows, want) and torch.equal(inv, want_inv)


def _float_plane(rng, n, device):
    """TPC-H-like amounts of both signs, ~2 % of rows not ok."""
    x = (np.round(rng.uniform(900, 105000, n), 2)
         - np.round(rng.uniform(1, 1000, n), 2) * rng.integers(1, 51, n))
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(rng.random(n) < 0.98).to(device))


@pytest.mark.parametrize("log2_n", [24, 26])
def test_float_items_at_large_capacity_equal_plain(cuda_device, log2_n):
    """Float items (float64 and float32) and an int64 item in planes of
    2^24 and 2^26 rows (Q9's 175 live groups of 2^23 slots): the kernel's
    rows, sum_lo and sum_hi among them, equal `accumulate_plain` bit for
    bit."""
    rng = np.random.default_rng(log2_n)
    n = 1 << log2_n
    x, ok = _float_plane(rng, n, cuda_device)
    items = [(x, ok), (x.to(torch.float32), ok),
             (torch.from_numpy(rng.integers(1, 51, n)).to(cuda_device), ok)]
    gid = torch.from_numpy(rng.integers(0, 175, n)).to(cuda_device)
    rows, inv = group_agg.accumulate_kernel(items, gid, 1 << 23)
    want, want_inv = group_agg.accumulate_plain(items, gid, 1 << 23)
    assert rows.shape == (4 + 4 + 2, 1 << 23)
    assert torch.equal(rows, want) and torch.equal(inv, want_inv)


def test_q1_eight_items_equal_plain(cuda_device):
    """Q1's launch: SUM(l_quantity), SUM(l_extendedprice), SUM(disc_price),
    SUM(charge), AVG(l_quantity)'s and AVG(l_discount)'s sums, AVG's
    count and COUNT(*) over 4 of 128 slots at 2^23 rows."""
    rng = np.random.default_rng(8)
    n = 1 << 23
    ok = torch.from_numpy(rng.random(n) < 0.98).to(cuda_device)
    qty = torch.from_numpy(rng.integers(1, 51, n)).to(cuda_device)
    ep = torch.from_numpy(np.round(rng.uniform(900, 105000, n), 2))
    disc = torch.from_numpy(np.round(rng.uniform(0, 0.1, n), 2))
    tax = torch.from_numpy(np.round(rng.uniform(0, 0.08, n), 2))
    ep, disc, tax = (t.to(cuda_device) for t in (ep, disc, tax))
    items = [(qty, ok), (ep, ok), (ep * (1 - disc), ok),
             (ep * (1 - disc) * (1 + tax), ok), (qty, ok), (disc, ok),
             (None, ok), (None, torch.ones_like(ok))]
    gid = torch.from_numpy(rng.integers(0, 4, n)).to(cuda_device)
    before = group_agg.launches
    rows, inv = group_agg.accumulate_kernel(items, gid, 128)
    assert group_agg.launches == before + 1
    want, want_inv = group_agg.accumulate_plain(items, gid, 128)
    assert torch.equal(rows, want) and torch.equal(inv, want_inv)


def test_sixteen_float_items_in_one_launch_equal_plain(cuda_device):
    """A launch of 16 float items, the most one takes (96 shared planes:
    the smallest shared table), over 2048 slots."""
    rng = np.random.default_rng(16)
    n = (1 << 20) + 5
    items = [_float_plane(rng, n, cuda_device) for _ in range(16)]
    items = [(x * (i + 1) if i % 2 else x.to(torch.float32), ok)
             for i, (x, ok) in enumerate(items)]
    gid = torch.from_numpy(rng.integers(-1, 2048, n)).to(cuda_device)
    before = group_agg.launches
    rows, inv = group_agg.accumulate_kernel(items, gid, 2048)
    assert group_agg.launches == before + 1
    want, want_inv = group_agg.accumulate_plain(items, gid, 2048)
    assert rows.shape == (64, 2048)
    assert torch.equal(rows, want) and torch.equal(inv, want_inv)


@pytest.mark.parametrize("G", [8, 1 << 22])
def test_group_of_2_20_rows_at_max_abs_equals_plain(cuda_device, G):
    """Groups of 2^20 rows at +-max|x| (q = +-(2^62 - 2^9): the low words
    carry) and all negative, in the shared table (G = 8) and past it in
    device memory (G = 2^22, the groups at its top): rows bit for bit the
    plain version's, and the sums exact."""
    rng = np.random.default_rng(20)
    m = 1 << 20
    M = 1024 - 2.0 ** -43
    x = np.concatenate([np.full(m, M), np.full(m, -M),
                        -rng.uniform(0.0, M, m)])
    gid = np.repeat(np.array([G - 3, G - 2, G - 1]), m)
    perm = rng.permutation(3 * m)
    items = [(torch.from_numpy(x[perm]).to(cuda_device),
              torch.ones(3 * m, dtype=torch.bool, device=cuda_device))]
    gid = torch.from_numpy(gid[perm]).to(cuda_device)
    rows, inv = group_agg.accumulate_kernel(items, gid, G)
    want, want_inv = group_agg.accumulate_plain(items, gid, G)
    assert torch.equal(rows, want) and torch.equal(inv, want_inv)
    (s, _), = group_agg.grouped_sums_counts_multi(items, gid, G)
    assert s[G - 3].item() == m * M and s[G - 2].item() == -m * M


def test_segment_aggregate_on_card_equals_plain_route(cuda_device):
    """segment_aggregate on the card (one group_agg launch per aggregate)
    gives the bits of the card's route with the plain accumulator."""
    gid, items, G = _engine_case("sorted runs", 1 << 16, cuda_device)
    g = gid.clamp(min=0)
    for v, ok in items[1:]:
        for func in ("count_star", "count", "sum", "avg", "min"):
            before = group_agg.launches
            got, has = K.segment_aggregate(func, v, ok, g, ok.shape[0], G)
            assert group_agg.launches == before + 1
            lm_ok = ok if func != "count_star" else torch.ones_like(ok)
            value = v if func in ("sum", "avg") else None
            s, c = group_agg.fixed_point([(value, lm_ok)], g, G,
                                         group_agg.accumulate_plain)[0]
            want = {"count_star": c, "count": c, "sum": s, "min": None,
                    "avg": s.to(torch.float64) / c.clamp(min=1)}[func]
            assert torch.equal(has, c > 0) or func in ("count_star", "count")
            if want is not None:
                assert torch.equal(got.view(torch.int64),
                                   want.view(torch.int64))


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


SMALL_GATHER_N = [0, 1, 5, (1 << 16) + 3]
SMALL_GATHER_T = [1, 1024, 4096]
# W <= 4 instantiated, 5 and up the runtime loop; at T = 4096, 15 and 32
# words exceed a block's shared memory: the table read through L1/L2
SMALL_GATHER_W = [1, 2, 3, 4, 5, 14, 15, 32]


def _gather_indices(rng, n, T, dtype):
    far = [-(2**31), 2**31 - 1] if dtype == np.int32 else \
        [-(2**31), 2**31, -(2**40), 2**40]
    idx = rng.integers(-1, T + 1, n + 1)
    special = [-1, T, *far]
    idx[1:1 + min(n, len(special))] = special[:n]
    return idx.astype(dtype)


@pytest.mark.parametrize("W", SMALL_GATHER_W)
@pytest.mark.parametrize("T", SMALL_GATHER_T)
@pytest.mark.parametrize("n", SMALL_GATHER_N)
def test_small_gather_kernel_matches_plain(cuda_device, n, T, W):
    """The int32 form, bit-exact against the plain version: indices of -1,
    T and +-2^31 included, an index tensor that starts on a 16-byte
    boundary and one sliced at offset 1 (the rows before the boundary and
    the stores off it go the scalar way)."""
    rng = np.random.default_rng(n + T + W)
    table = rng.integers(-(2**31), 2**31, (T, W)).astype(np.int32)
    tt = torch.from_numpy(table).to(cuda_device)
    whole = torch.from_numpy(_gather_indices(rng, n, T, np.int32)).to(
        cuda_device)
    for ti in (whole[:n], whole[1:]):
        before = small_gather.launches
        got = small_gather.gather_words(ti, tt)
        torch.cuda.synchronize()
        assert small_gather.launches == before + (n > 0)
        assert got.is_cuda and got.dtype == torch.int32 and got.shape == (n, W)
        assert torch.equal(got, small_gather.gather_words_plain(ti, tt))


@pytest.mark.parametrize("W", SMALL_GATHER_W)
@pytest.mark.parametrize("T", SMALL_GATHER_T)
@pytest.mark.parametrize("n", SMALL_GATHER_N)
def test_small_gather_planes_kernel_matches_plain(cuda_device, n, T, W):
    """The join's form (int64 indices and planes), bit-exact against its
    plain version: indices of -1, T, +-2^31 and +-2^40, plane values with
    bits above the low 32, aligned and offset-1 index views."""
    rng = np.random.default_rng(n + T + W + 1)
    planes = torch.from_numpy(rng.integers(0, 2**36, (W, T))).to(cuda_device)
    whole = torch.from_numpy(_gather_indices(rng, n, T, np.int64)).to(
        cuda_device)
    for ti in (whole[:n], whole[1:]):
        before = small_gather.launches
        got = small_gather.gather_word_planes(ti, planes)
        torch.cuda.synchronize()
        assert small_gather.launches == before + (n > 0)
        assert got.is_cuda and got.dtype == torch.int64 and got.shape == (W, n)
        assert torch.equal(got,
                           small_gather.gather_word_planes_plain(ti, planes))


@pytest.mark.parametrize("n", [5, (1 << 16) + 3])
def test_small_gather_empty_table_gives_zeros(cuda_device, n):
    """T = 0: every index is out of range, both forms launch and write
    zeros."""
    rng = np.random.default_rng(n)
    i64 = torch.from_numpy(_gather_indices(rng, n, 0, np.int64)[:n]).to(
        cuda_device)
    for W in (1, 3, 5):
        got = small_gather.gather_words(
            i64.to(torch.int32),
            torch.zeros((0, W), dtype=torch.int32, device=cuda_device))
        planes = small_gather.gather_word_planes(
            i64, torch.zeros((W, 0), dtype=torch.int64, device=cuda_device))
        torch.cuda.synchronize()
        assert got.shape == (n, W) and not got.any()
        assert planes.shape == (W, n) and not planes.any()


def test_small_gather_planes_replays_in_a_graph(cuda_device):
    """The join's form captured into a CUDA graph (as the pipeline captures
    it) and replayed over new index contents."""
    rng = np.random.default_rng(8)
    T, W, n = 1024, 3, (1 << 16) + 5
    planes = torch.from_numpy(rng.integers(0, 2**32, (W, T))).to(cuda_device)
    idx = torch.from_numpy(_gather_indices(rng, n, T, np.int64)[:n]).to(
        cuda_device)
    small_gather.gather_word_planes(idx, planes)  # eager: caches the limits
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = small_gather.gather_word_planes(idx, planes)
    for seed in (1, 2):
        fresh = np.random.default_rng(seed)
        idx.copy_(torch.from_numpy(_gather_indices(fresh, n, T, np.int64)[:n]))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out,
                           small_gather.gather_word_planes_plain(idx, planes))


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
    # the join gathers only the columns a query reads: Query A's bonus
    # packs (the fused route), Query B's rate does not (the lookup route)
    assert (small_gather.launches > gathers) == (
        mxu_gather == "1" and query == QUERY_B)


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


def _agg_inputs(n, case, num_groups, device):
    """"dense": every group below num_groups and every chunk lane (values
    over the full int64 range), 2 % of gid -1 and 1 % at or past
    num_groups; "sparse": a few groups, most gid -1, values near +-2^63;
    "none": every row excluded (gid -1)."""
    rng = np.random.default_rng(n + len(case) + num_groups)
    values = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64,
                          endpoint=True)
    ok = rng.random(n) < 0.97
    if case == "dense":
        gid = rng.integers(0, num_groups, n).astype(np.int32)
        gid[rng.random(n) < 0.02] = -1
        gid[rng.random(n) < 0.01] = num_groups + rng.integers(0, 500)
    elif case == "sparse":
        gid = np.full(n, -1, np.int32)
        few = rng.random(n) < 0.01
        gid[few] = rng.choice([0, 1, 127, 128, 511, 1000, 1023], few.sum())
        values = np.where(rng.random(n) < 0.5, 2**63 - 1 - values % 1000,
                          -(2**63) + values % 1000)
    else:
        gid = np.full(n, -1, np.int32)
    values[:2] = [-(2**63), 2**63 - 1]
    return tuple(torch.from_numpy(a).to(device) for a in (values, ok, gid))


N_RAGGED = (1 << 20) + 5
ONEHOT_CASES = [  # (variant, num_groups, n, data, offset in rows)
    *[(v, g, N_RAGGED, data, 0)
      for v, g in [("v1", 1024), ("v2", 1024), ("v4", 1024), ("v5", 1024),
                   ("s8", 1024), ("s8", 1000)]
      for data in ("dense", "sparse")],
    # fewer rows than one k-step (s8: 32 rows, v1, v2, v4, v5: 16)
    ("s8", 1024, 31, "dense", 0), ("v1", 1024, 7, "dense", 0),
    ("v2", 1024, 15, "dense", 0), ("v4", 1024, 15, "dense", 0),
    ("v5", 1024, 9, "dense", 0),
    # not a multiple of the stage ring (s8, v1, v2: 6 k-steps; v4, v5: 16
    # stages of two k16 slices, 32 rows) or of 4
    ("s8", 1024, 32 * 6 * 7 + 3, "dense", 0),
    ("v1", 1024, 16 * 6 * 7 + 5, "dense", 0), ("v2", 1024, 4099, "dense", 0),
    ("v4", 1024, 32 * 16 * 7 + 5, "dense", 0),
    ("v5", 1024, 32 * 16 * 7 + 21, "dense", 0),
    # a block's rows span the 65,536-row flush of the bytes kernels (every
    # warpgroup sees every row); v4 and v5's two warpgroups take the steps
    # in turn, so their accumulators cross the flush at twice the rows
    *[(v, 1024, 70_000 * 133, "dense", 0) for v in ("v1", "v2", "v4", "v5")],
    *[(v, 1024, 140_000 * 133, "dense", 0) for v in ("v4", "v5")],
    # every row excluded
    ("s8", 1024, 5000, "none", 0), ("v1", 1024, 5000, "none", 0),
    ("v2", 1024, 3, "none", 0), ("v4", 1024, 5000, "none", 0),
    ("v5", 1024, 3, "none", 0),
    # s8: one partial m64 tile, one full, one full and one partial (the
    # other tiles issue no wgmma)
    ("s8", 1, 777, "dense", 0), ("s8", 64, 5000, "dense", 0),
    ("s8", 65, 4099, "dense", 0),
    # planes that start 4 rows (16 bytes) into their storage
    *[(v, 1024, 10_001, "dense", 4) for v in ("v1", "v2", "v4", "v5", "s8")],
]


@pytest.mark.parametrize(
    "variant,num_groups,n,data,offset", ONEHOT_CASES,
    ids=[f"{v}-G{g}-n{n}-{d}" + (f"-at{o}" if o else "")
         for v, g, n, d, o in ONEHOT_CASES])
def test_onehot_kernel_chunk_totals_match_plain(cuda_device, variant,
                                                num_groups, n, data, offset):
    """Each one-hot tensor-core kernel's chunk totals equal its plain
    version's bit for bit, and two launches give identical bits: at 2^20 + 5
    rows (a ragged tail) and at the edges of the kernels' tiling (see
    ONEHOT_CASES)."""
    values, ok, gid = _agg_inputs(n + offset, data, num_groups, cuda_device)
    vlo, vhi, gid_m = (t[offset:] for t in AV.prepare(values, ok, gid))
    values, ok, gid = values[offset:], ok[offset:], gid[offset:]
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
    if data == "none":
        assert not got.any()


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


# one query of each subquery form, each with rows at 2^14 lineitem rows
SUBQUERY_FORMS = {"scalar": "Q11", "IN": "Q18", "EXISTS": "Q4",
                  "correlated value": "Q17", "shared CTE": "Q15",
                  "COUNT(DISTINCT)": "Q16"}


@pytest.mark.parametrize("form", list(SUBQUERY_FORMS))
def test_subquery_form_replays_on_card(tpch_sessions, form):
    """The first run and two warm runs of each form equal the numpy oracle;
    the warm runs replay captured programs (a subquery's new result batch
    is captured anew, then replayed)."""
    tables, _, gpu = tpch_sessions
    q = SUBQUERY_FORMS[form]
    text = tpch_queries.QUERIES[q]
    want = tpch_oracle.run(q, tables)
    assert want
    keys = tpch_oracle.FLOAT_SORT_KEYS.get(q, ())
    tpch_oracle.compare(gpu.sql(text).to_pylist(), want, keys)
    st = dict(gpu.executor.pipeline.stats)
    for _ in range(2):
        tpch_oracle.compare(gpu.sql(text).to_pylist(), want, keys)
    after = gpu.executor.pipeline.stats
    assert after["replays"] >= st["replays"] + 2, after
    assert after["fallbacks"] == st["fallbacks"], after


def test_no_subplan_runs_while_a_stream_captures(tpch_sessions):
    """Every plan the ten subquery queries execute (the pipeline's subplans
    and leaves, the eager evaluator's subqueries) runs outside a capture,
    on the first run and on a warm run."""
    tables, _, gpu = tpch_sessions
    ex = gpu.executor
    seen = []

    def spy(fn):
        def run(plan):
            seen.append(torch.cuda.is_current_stream_capturing())
            return fn(plan)
        return run

    execute, sub = ex.execute, ex.evaluator.subquery_exec
    ex.execute, ex.evaluator.subquery_exec = spy(execute), spy(sub)
    captures = ex.pipeline.stats["captures"]
    try:
        for q in tpch_queries.WITH_SUBQUERIES:
            for _ in range(2):
                tpch_oracle.compare(
                    gpu.sql(tpch_queries.QUERIES[q]).to_pylist(),
                    tpch_oracle.run(q, tables),
                    tpch_oracle.FLOAT_SORT_KEYS.get(q, ()))
    finally:
        ex.execute, ex.evaluator.subquery_exec = execute, sub
    assert seen and not any(seen), (len(seen), sum(seen))
    assert ex.pipeline.stats["captures"] > captures


@pytest.mark.parametrize("func", ["count", "sum", "avg"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_group_agg_with_a_dedup_plane_equals_plain(cuda_device, func, dtype):
    """COUNT/SUM/AVG(DISTINCT) on the card: one group_agg launch over the
    ok plane deduped by distinct_first_flags, bit for bit its plain version
    on the same tensors, and equal to the CPU route."""
    rng = np.random.default_rng(5)
    n, G = (1 << 16) + 3, 700
    vals = rng.integers(-50, 50, n)
    data = torch.from_numpy(vals if dtype == torch.int64 else vals * 0.25)
    valid = torch.from_numpy(rng.random(n) > 0.1)
    gid = torch.from_numpy(rng.integers(0, G, n))
    cpu = (data, valid, gid)
    data, valid, gid = (t.to(cuda_device) for t in cpu)
    first = K.distinct_first_flags([data], [valid], gid, n - 5)
    assert first.is_cuda
    torch.testing.assert_close(
        first.cpu(), K.distinct_first_flags([cpu[0]], [cpu[1]], cpu[2],
                                            n - 5), rtol=0, atol=0)
    ok = K.live_mask(n, n - 5, cuda_device) & valid & first
    before = group_agg.launches
    got, has = K.segment_aggregate(func, data, valid, gid, n - 5, G,
                                   distinct_first=first)
    assert group_agg.launches == before + 1
    value = data if func != "count" else None
    (s, c), = group_agg.fixed_point([(value, ok)], gid, G,
                                    group_agg.accumulate_plain)
    plain = {"count": c, "sum": s,
             "avg": s.to(torch.float64) / c.clamp(min=1)}[func]
    assert torch.equal(got.view(torch.int64) if got.is_floating_point()
                       else got,
                       plain.view(torch.int64) if plain.is_floating_point()
                       else plain)
    want, want_has = K.segment_aggregate(
        func, *cpu[:3], n - 5, G,
        distinct_first=K.distinct_first_flags([cpu[0]], [cpu[1]], cpu[2],
                                              n - 5))
    assert torch.equal(has.cpu(), want_has)
    torch.testing.assert_close(got.cpu()[want_has], want[want_has],
                               rtol=1e-12, atol=0)
