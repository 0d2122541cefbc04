"""The grouped counts and sums of the port's engine on the card's route,
emulated on the CPU.

On a CUDA tensor every COUNT, SUM and AVG over segments is one launch of the
group_agg kernel. Here the route is emulated on CPU tensors: the
`card_route` fixture makes `group_agg.on_card` say yes and stands the
kernel's plain version (`accumulate_plain`, bit for bit the kernel) in for
the launch, and it counts every call that reaches the CPU's plain
accumulators. Checks:

* `segment_aggregate` on that route gives the bits of the route the card
  took before (int64 `index_add_` for counts and integer sums, fixed point
  with a stacked int64 accumulator for float sums), and reaches no CPU
  accumulator;
* on the CPU route it still equals the JAX package's `segment_aggregate`;
* the 22 TPC-H queries and the bench query on that route equal the numpy
  oracle, launch the kernel in the queries that aggregate (the subquery
  queries' grouped subplans and Q16's COUNT(DISTINCT) among them), and
  reach `accumulate_plain` and `grouped_sums_counts_multi_plain` never.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.ops import kernels as JK
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import group_agg as tga
from query_engine_tpu_torch.ops import kernels as TK
from query_engine_tpu_torch.tpch import data, oracle, queries

CAP = 512
N = 451  # live rows; rows [N, CAP) are pad rows
PLAIN = ("accumulate_plain", "grouped_sums_counts_multi_plain")


@pytest.fixture()
def card_route(monkeypatch):
    """The card's route on CPU tensors. Returns the call counts: "kernel"
    for the stand-in launches, and one per CPU plain accumulator."""
    plain = tga.accumulate_plain
    calls = dict.fromkeys(("kernel",) + PLAIN, 0)

    def kernel(items, gid, num_groups):
        calls["kernel"] += 1
        return plain(items, gid, num_groups)

    def spy(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(tga, "on_card", lambda t: True)
    monkeypatch.setattr(tga, "accumulate_kernel", kernel)
    for name in PLAIN:
        monkeypatch.setattr(tga, name, spy(name, getattr(tga, name)))
    return calls


def _column(rng, kind):
    if kind == "i64":
        data_ = rng.integers(-(2**62), 2**62, CAP)
    elif kind == "i32":
        data_ = rng.integers(-(2**31), 2**31, CAP).astype(np.int32)
    elif kind == "f32":
        data_ = rng.normal(0, 50, CAP).astype(np.float32)
    else:
        data_ = rng.normal(0, 1e5, CAP)
        data_[rng.permutation(CAP)[:4]] = [np.inf, -np.inf, np.nan, 1e300]
    return data_, rng.random(CAP) > 0.2


def _ids(rng, case, G):
    if case == "sorted runs":
        return np.repeat(np.arange(CAP), rng.integers(1, 6, CAP))[:CAP]
    if case == "few live":
        return rng.integers(0, 9, CAP)
    ids = rng.integers(0, G, CAP)
    ids[rng.random(CAP) < 0.1] = G + 3  # dropped
    return ids


def _before(func, data_, valid, gid, G):
    """The card's route before: int64 index_add_ for counts and integer
    sums; for float sums q = round(x * 2^k), its low and high 32 bits
    summed in int64 apart, with +inf, -inf and NaN counts; each group's
    exact sum of q rebuilt as a Python int, rounded once to float64 and
    rescaled."""
    def seg(v):
        ok = (gid >= 0) & (gid < G)
        out = torch.zeros(G, dtype=torch.int64)
        return out.index_add_(0, torch.where(ok, gid, 0),
                              torch.where(ok, v.to(torch.int64), 0))

    lm = torch.arange(CAP) < N
    ok = lm if func == "count_star" else lm & valid
    cnt = seg(ok)
    if func in ("count_star", "count"):
        return cnt
    if data_.is_floating_point():
        q, inv = tga.quantize(data_, ok)
        x = data_.to(torch.float64)
        lo = seg(torch.where(ok, q & 0xFFFFFFFF, 0)).tolist()
        hi = seg(torch.where(ok, q >> 32, 0)).tolist()
        s = torch.tensor([float(h * 2**32 + w) for w, h in zip(lo, hi)],
                         dtype=torch.float64) * inv
        p, ng, nn = (seg(ok & cls(x)) > 0 for cls in (
            torch.isposinf, torch.isneginf, torch.isnan))
        s = torch.where(p & ~ng, float("inf"), s)
        s = torch.where(ng & ~p, float("-inf"), s)
        s = torch.where(nn | (p & ng), float("nan"), s)
    else:
        s = seg(torch.where(ok, data_.to(torch.int64), 0))
    return s if func == "sum" else s.to(torch.float64) / cnt.clamp(min=1)


def _bits(t):
    return t.view(torch.int64) if t.is_floating_point() else t


@pytest.mark.parametrize("case,G", [("uniform", 37), ("sorted runs", 1024),
                                    ("few live", 1 << 14)])
@pytest.mark.parametrize("kind", ["i64", "i32", "f64", "f32"])
@pytest.mark.parametrize("func", ["count_star", "count", "sum", "avg"])
def test_card_route_same_bits_as_before(card_route, func, kind, case, G):
    rng = np.random.default_rng(len(case) + G)
    d, v = _column(rng, kind)
    data_, valid = torch.from_numpy(d), torch.from_numpy(v)
    gid = torch.from_numpy(_ids(rng, case, G))
    got, has = TK.segment_aggregate(func, data_, valid, gid, N, G)
    want = _before(func, data_, valid, gid, G)
    assert torch.equal(_bits(got), _bits(want))
    if func in ("sum", "avg"):
        assert torch.equal(has, _before("count", data_, valid, gid, G) > 0)
    assert card_route["kernel"] == 1
    assert all(card_route[name] == 0 for name in PLAIN), card_route


@pytest.mark.parametrize("func", ["min", "max"])
def test_card_route_counts_min_max_groups_with_the_kernel(card_route, func):
    """MIN and MAX scatter their values; the count that marks their empty
    groups is the kernel's."""
    rng = np.random.default_rng(3)
    d, v = _column(rng, "i64")
    data_, valid = torch.from_numpy(d), torch.from_numpy(v)
    gid = torch.from_numpy(_ids(rng, "uniform", 37))
    got, has = TK.segment_aggregate(func, data_, valid, gid, N, 37)
    assert torch.equal(has, _before("count", data_, valid, gid, 37) > 0)
    ok = (torch.arange(CAP) < N) & valid
    want = TK._segment_extreme(data_, ok, gid, 37, func == "min")
    assert torch.equal(got[has], want[has])
    assert card_route["kernel"] == 1
    assert all(card_route[name] == 0 for name in PLAIN), card_route


@pytest.mark.parametrize("case,G", [("sorted runs", 1024),
                                    ("few live", 1 << 14)])
@pytest.mark.parametrize("func", ["count_star", "count", "sum", "avg"])
@pytest.mark.parametrize("kind", ["i64", "f64"])
def test_cpu_route_matches_jax(func, kind, case, G):
    rng = np.random.default_rng(len(case) + G)
    d, v = _column(rng, kind)
    d = np.where(np.isfinite(d), d, 0.5) if kind == "f64" else d
    ids = np.minimum(_ids(rng, case, G), G - 1)
    pv, pok = TK.segment_aggregate(func, torch.from_numpy(d),
                                   torch.from_numpy(v), torch.from_numpy(ids),
                                   N, G)
    jv, jok = JK.segment_aggregate(func, jnp.asarray(d), jnp.asarray(v),
                                   jnp.asarray(ids), N, G)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    np.testing.assert_allclose(pv.numpy()[ok], np.asarray(jv)[ok], rtol=1e-12)


# the queries that count or sum over groups: every one but Q6, Q14 and Q19
# (the ten with subqueries through their grouped subplans, Q16 through its
# COUNT(DISTINCT))
TPCH_AGG = ["Q1", "Q3", "Q5", "Q8", "Q9", "Q10", "Q12", "Q13",
            *queries.WITH_SUBQUERIES]


@pytest.fixture(scope="module")
def tpch_tables():
    return data.generate(1 << 11)


@pytest.mark.parametrize("q", list(queries.QUERIES))
def test_tpch_on_card_route_reaches_no_plain_accumulator(card_route,
                                                         tpch_tables, q):
    """Under the card's admission rule (string filters as eager leaves, the
    capture stubbed) each query equals the numpy oracle; the aggregating
    queries launch the kernel; no count or sum reaches a CPU accumulator."""
    s = Session(device="cpu")
    s.executor.pipeline._graphs = True
    s.executor.pipeline._capture = lambda *args: None
    data.register(s, tpch_tables)
    got = s.sql(queries.QUERIES[q]).to_pylist()
    oracle.compare(got, oracle.run(q, tpch_tables),
                   oracle.FLOAT_SORT_KEYS.get(q, ()))
    if q in TPCH_AGG:
        assert card_route["kernel"] > 0
    assert all(card_route[name] == 0 for name in PLAIN), card_route


@pytest.mark.parametrize("compiled", [True, False],
                         ids=["compiled", "QE_COMPILED=0"])
def test_bench_query_on_card_route(card_route, compiled):
    rng = np.random.default_rng(7)
    n = 3000
    f = {"age": rng.integers(18, 65, n),
         "salary": rng.integers(50_000, 150_000, n),
         "dept": rng.integers(0, 1024, n)}
    d = {"dept_id": np.arange(1024), "bonus": rng.integers(0, 1000, 1024)}
    q = ("SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
         "FROM f JOIN d ON f.dept = d.dept_id "
         "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10")
    m = f["age"] > 25
    c = np.bincount(f["dept"][m], minlength=1024)
    tot = np.bincount(f["dept"][m], weights=f["salary"][m]
                      + d["bonus"][f["dept"][m]], minlength=1024)
    groups = np.nonzero(c)[0]
    order = groups[np.argsort(-tot[groups], kind="stable")][:10]
    want = [(int(g), int(c[g]), int(tot[g])) for g in order]
    s = Session(device="cpu")
    s.executor._compiled = compiled
    s.register_table("f", ColumnBatch.from_pydict(f))
    s.register_table("d", ColumnBatch.from_pydict(d))
    assert s.sql(q).to_pylist() == want
    assert card_route["kernel"] > 0
    assert all(card_route[name] == 0 for name in PLAIN), card_route
