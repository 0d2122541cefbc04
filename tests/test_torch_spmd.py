"""The port's mesh building blocks (`query_engine_tpu_torch/parallel/`:
mesh.py, spmd.py, overlap.py, dict_merge.py) held against the JAX
package on the same numpy inputs.

The JAX functions run on the 8 virtual CPU devices (tests/conftest.py);
the port's on `make_mesh(["cpu"] * 8)`, eight virtual shards in host
threads. Integers, per-shard counts and overflow flags must be equal,
floats within rtol 1e-9, compared over live slots (a pad slot's index
past a destination's count is garbage in both).

The cases are those of tests/test_spmd.py, plus `bucket_rows` alone in
both branches, the sort's sample positions over a sweep of sizes, the
collectives, a shard that raises (the others do not hang), and the card's
route for grouped sums (group_agg, no index_add_) emulated on the CPU.
"""

import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (x64)
from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.parallel import spmd as jspmd
from query_engine_tpu.parallel.dict_merge import (
    ingest_sharded_strings as j_ingest,
)
from query_engine_tpu.parallel.mesh import ShardedTable as JTable
from query_engine_tpu.parallel.mesh import make_mesh as j_make_mesh
from query_engine_tpu.parallel.overlap import (
    make_overlapped_exchange_aggregate as j_overlapped,
    make_sequential_exchange_aggregate as j_sequential,
)

from query_engine_tpu_torch.columnar.batch import ColumnBatch as TBatch
from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.ops import group_agg as tga
from query_engine_tpu_torch.parallel import spmd as tspmd
from query_engine_tpu_torch.parallel.dict_merge import (
    ingest_sharded_strings as t_ingest,
)
from query_engine_tpu_torch.parallel.mesh import P
from query_engine_tpu_torch.parallel.mesh import ShardedTable as TTable
from query_engine_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from query_engine_tpu_torch.parallel.overlap import (
    make_overlapped_exchange_aggregate as t_overlapped,
    make_sequential_exchange_aggregate as t_sequential,
)

N_DEV = 8
RTOL = 1e-9


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= N_DEV, "conftest must force 8 CPU devices"
    return j_make_mesh(jax.devices()[:N_DEV])


@pytest.fixture(scope="module")
def tmesh():
    return t_make_mesh(["cpu"] * N_DEV)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tables(data, jmesh, tmesh):
    return (JTable(JBatch.from_pydict(data), jmesh),
            TTable(TBatch.from_pydict(data), tmesh))


def _args(st, cols):
    """Key planes, validities, shard rows, arg planes, validities."""
    return ([st.datas[i] for i in cols[0]] + [st.valids[i] for i in cols[0]]
            + [st.shard_rows] + [st.datas[i] for i in cols[1]]
            + [st.valids[i] for i in cols[1]])


def _equal(a, b, what, valid=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if valid is not None:
        a, b = a[valid], b[valid]
    if np.issubdtype(a.dtype, np.floating) or np.issubdtype(b.dtype,
                                                            np.floating):
        np.testing.assert_allclose(b.astype(np.float64),
                                   a.astype(np.float64), rtol=RTOL,
                                   err_msg=what)
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), what


def _live(counts, per):
    """Slots [s * per, s * per + counts[s]) of a sharded plane."""
    counts = _np(counts).reshape(-1)
    m = np.zeros(len(counts) * per, bool)
    for s, c in enumerate(counts):
        m[s * per: s * per + min(int(c), per)] = True
    return m


def _agg_outputs_equal(jout, tout, n_keys, n_combine):
    """Per-shard group counts equal; every plane equal over live groups
    (key and partial values where their validity says so)."""
    assert len(jout) == len(tout)
    _equal(jout[-1], tout[-1], "groups per shard")
    per = _np(jout[0]).shape[0] // N_DEV
    live = _live(jout[-1], per)
    for i in range(2 * n_keys):
        _equal(jout[i], tout[i], f"key plane {i}", live)
    for c in range(n_combine):
        v = 2 * n_keys + 2 * c
        _equal(jout[v + 1], tout[v + 1], f"partial {c} validity", live)
        ok = live & _np(jout[v + 1]).astype(bool)
        _equal(jout[v], tout[v], f"partial {c} values", ok)


def test_sharded_table_layout_and_roundtrip(jmesh, tmesh):
    rng = np.random.default_rng(0)
    n = 1000
    data = {"k": rng.integers(0, 50, n).tolist(),
            "v": [None if i % 17 == 0 else int(x)
                  for i, x in enumerate(rng.integers(0, 100, n))]}
    jt, tt = _tables(data, jmesh, tmesh)
    assert tt.shard_capacity == jt.shard_capacity
    _equal(jt.shard_rows, tt.shard_rows, "shard rows")
    for c in range(2):
        _equal(jt.datas[c], tt.datas[c], f"data plane {c}")
        _equal(jt.valids[c], tt.valids[c], f"validity plane {c}")
    back = tt.to_batch()
    assert back.num_rows == n
    assert back.to_pydict() == TBatch.from_pydict(data).to_pydict()


@pytest.mark.parametrize("n_parts,per,dead", [(8, 40, 0.1), (8, 3, 0.0),
                                              (40, 12, 0.2), (40, 2, 0.0)])
def test_bucket_rows_both_branches(n_parts, per, dead):
    """<= 32 destinations: the counting scatter; above: the stable sort.
    Small `per` drops rows past a destination's capacity."""
    rng = np.random.default_rng(n_parts * 100 + per)
    rows = 300
    pid = rng.integers(0, n_parts, rows).astype(np.int32)
    live = rng.random(rows) >= dead
    jidx, jcnt = jspmd.bucket_rows(jnp.asarray(pid), jnp.asarray(live),
                                   n_parts, per)
    tidx, tcnt = tspmd.bucket_rows(torch.as_tensor(pid),
                                   torch.as_tensor(live), n_parts, per)
    _equal(jcnt, tcnt, "counts")
    assert tuple(tidx.shape) == (n_parts, per)
    filled = np.arange(per)[None, :] < np.minimum(_np(jcnt), per)[:, None]
    _equal(jidx, tidx, "row index slots", filled)
    # each filled slot holds a live row of its destination, in row order
    t = _np(tidx)
    for d in range(n_parts):
        mine = t[d][filled[d]]
        assert np.all(pid[mine] == d) and np.all(live[mine])
        assert np.all(np.diff(mine) > 0)


def test_distributed_aggregate_matches_jax(jmesh, tmesh):
    rng = np.random.default_rng(1)
    n = 2000
    keys = rng.integers(0, 37, n)
    vals = rng.integers(-50, 50, n)
    kv = rng.random(n) > 0.05
    vv = rng.random(n) > 0.1
    data = {"k": [int(k) if ok else None for k, ok in zip(keys, kv)],
            "v": [int(v) if ok else None for v, ok in zip(vals, vv)]}
    jt, tt = _tables(data, jmesh, tmesh)
    aggs = [("count_star", -1), ("sum", 0), ("min", 0), ("max", 0),
            ("avg", 0)]
    jout = jspmd.make_distributed_aggregate(jmesh, aggs, n_args=1)(
        *_args(jt, ([0], [1])))
    tout = tspmd.make_distributed_aggregate(tmesh, aggs, n_args=1)(
        *_args(tt, ([0], [1])))
    _agg_outputs_equal(jout, tout, 1, 6)
    # and against a host model: one group per key, no group split
    per = _np(tout[0]).shape[0] // N_DEV
    got = {}
    for s in range(N_DEV):
        for i in range(int(tout[-1][s])):
            j = s * per + i
            key = int(tout[0][j]) if bool(tout[1][j]) else None
            assert key not in got, "group split across shards"
            got[key] = int(tout[2][j])
    want = collections.Counter(int(k) if ok else None
                               for k, ok in zip(keys, kv))
    assert got == dict(want)


def test_distributed_aggregate_float_avg(jmesh, tmesh):
    """AVG's float64 sum and count partials, combined by a float SUM."""
    rng = np.random.default_rng(5)
    n = 1500
    data = {"k": rng.integers(0, 60, n).tolist(),
            "x": np.round(rng.normal(0, 1e4, n), 4).tolist()}
    jt, tt = _tables(data, jmesh, tmesh)
    aggs = [("avg", 0), ("sum", 0), ("max", 0)]
    jout = jspmd.make_distributed_aggregate(jmesh, aggs, 1,
                                            group_capacity=128)(
        *_args(jt, ([0], [1])))
    tout = tspmd.make_distributed_aggregate(tmesh, aggs, 1,
                                            group_capacity=128)(
        *_args(tt, ([0], [1])))
    _agg_outputs_equal(jout, tout, 1, 4)


def test_distributed_aggregate_multikey(jmesh, tmesh):
    rng = np.random.default_rng(21)
    n = 1200
    data = {"k1": rng.integers(0, 6, n).tolist(),
            "k2": rng.integers(0, 5, n).tolist(),
            "v": rng.integers(0, 100, n).tolist()}
    jt, tt = _tables(data, jmesh, tmesh)
    aggs = [("count_star", -1), ("sum", 0)]
    jout = jspmd.make_distributed_aggregate(jmesh, aggs, 1, n_keys=2)(
        *_args(jt, ([0, 1], [2])))
    tout = tspmd.make_distributed_aggregate(tmesh, aggs, 1, n_keys=2)(
        *_args(tt, ([0, 1], [2])))
    _agg_outputs_equal(jout, tout, 2, 2)


def test_distributed_aggregate_group_capacity_cuts(jmesh, tmesh):
    """A group_capacity below the shard's groups cuts partial groups off,
    with no flag, in both packages alike."""
    rng = np.random.default_rng(8)
    data = {"k": rng.integers(0, 400, 1600).tolist(),
            "v": rng.integers(0, 9, 1600).tolist()}
    jt, tt = _tables(data, jmesh, tmesh)
    aggs = [("count", 0), ("sum", 0)]
    jout = jspmd.make_distributed_aggregate(jmesh, aggs, 1,
                                            group_capacity=64)(
        *_args(jt, ([0], [1])))
    tout = tspmd.make_distributed_aggregate(tmesh, aggs, 1,
                                            group_capacity=64)(
        *_args(tt, ([0], [1])))
    _agg_outputs_equal(jout, tout, 1, 2)
    assert int(_np(tout[2]).sum()) < 1600  # rows of cut groups are lost


def _sort_equal(jout, tout, n_cols):
    _equal(jout[-1], tout[-1], "overflow")
    _equal(jout[-2], tout[-2], "rows per shard")
    per = _np(jout[0]).shape[0] // N_DEV
    live = _live(jout[-2], per)
    for i in range(2 * (n_cols + 1)):
        _equal(jout[i], tout[i], f"sorted plane {i}", live)


def test_distributed_sort_global_order(jmesh, tmesh):
    rng = np.random.default_rng(2)
    n = 1500
    keys = rng.integers(-1000, 1000, n)
    data = {"k": [None if i % 23 == 0 else int(k)
                  for i, k in enumerate(keys)], "payload": list(range(n))}
    jt, tt = _tables(data, jmesh, tmesh)
    jout = jspmd.make_distributed_sort(jmesh, n_cols=1)(
        jt.datas[0], jt.valids[0], jt.shard_rows, jt.datas[1], jt.valids[1])
    tout = tspmd.make_distributed_sort(tmesh, n_cols=1)(
        tt.datas[0], tt.valids[0], tt.shard_rows, tt.datas[1], tt.valids[1])
    _sort_equal(jout, tout, 1)
    assert int(tout[-1].sum()) == 0
    per = tout[0].shape[0] // N_DEV
    got = []
    for s in range(N_DEV):
        c = int(tout[-2][s])
        got += [int(k) if v else None for k, v in
                zip(tout[0][s * per: s * per + c], tout[2][s * per:
                                                           s * per + c])]
    live = sorted(int(k) for i, k in enumerate(keys) if i % 23)
    assert got == live + [None] * (n - len(live))


def test_distributed_sort_float_keys_bounded(jmesh, tmesh):
    """Float64 keys with duplicates, a small sample and a tight factor:
    equal pivots, counts and overflow to JAX's, whatever they are."""
    rng = np.random.default_rng(4)
    n = 2000
    data = {"x": np.round(rng.exponential(50, n), 1).tolist()}
    jt, tt = _tables(data, jmesh, tmesh)
    for factor in (1.0, 1.5, None):
        jout = jspmd.make_distributed_sort(jmesh, 0, n_samples=16,
                                           recv_factor=factor)(
            jt.datas[0], jt.valids[0], jt.shard_rows)
        tout = tspmd.make_distributed_sort(tmesh, 0, n_samples=16,
                                           recv_factor=factor)(
            tt.datas[0], tt.valids[0], tt.shard_rows)
        _sort_equal(jout, tout, 0)


@pytest.mark.parametrize("s", [2, 3, 1000, 1024, 2048, 3000, 4096, 8192])
def test_sort_sample_positions_equal_jax(s):
    """The stride sample's positions: float64 linspace times n_rows - 1,
    truncated. torch.linspace differs from jnp.linspace in the last ulp
    at some positions, so the port computes JAX's formula."""
    sizes = [1, 2, 7, 1000, 262_143, 1_499_999, 1_500_000, 1_500_304,
             2_097_152, 6_001_215]
    sizes += np.random.default_rng(s).integers(1, 1 << 24, 20).tolist()
    rows = np.asarray(sizes, np.int64)
    span = jnp.maximum(jnp.asarray(rows) - 1, 0).astype(jnp.float64)
    want = np.asarray((jnp.linspace(0.0, 1.0, s)[None, :]
                       * span[:, None]).astype(jnp.int64))
    lin = tspmd.linspace01(s, "cpu")
    assert np.array_equal(lin.numpy(), np.asarray(jnp.linspace(0.0, 1.0, s)))
    tspan = (torch.as_tensor(rows) - 1).clamp(min=0).to(torch.float64)
    got = (lin[None, :] * tspan[:, None]).to(torch.int64).numpy()
    assert np.array_equal(got, want)


def _join_inputs(st, n_left=1):
    return [st[0].datas[0], st[0].valids[0], st[0].shard_rows,
            st[1].datas[0], st[1].valids[0], st[1].shard_rows,
            st[0].datas[1], st[0].valids[1], st[1].datas[1], st[1].valids[1]]


def _join_equal(jout, tout, lper_cap, rper_cap):
    """Totals, counts and overflow equal; the compacted planes and the
    per-left-row counts and ranks over their live slots."""
    for i, what in ((0, "totals"), (1, "left rows"), (2, "right rows"),
                    (-1, "overflow")):
        _equal(jout[i], tout[i], what)
    lper = _np(jout[3]).shape[0] // N_DEV
    lcnt = np.minimum(_np(jout[1]), lper)
    llive = _live(lcnt, lper)
    _equal(jout[3], tout[3], "per-row counts", llive)
    _equal(jout[4], tout[4], "left ranks", llive)
    for i in (7, 8, 9, 10):   # left key, left col, their validities
        _equal(jout[i], tout[i], f"left plane {i}", llive)
    rper = _np(jout[11]).shape[0] // N_DEV
    rlive = _live(np.minimum(_np(jout[2]), rper), rper)
    for i in (11, 12, 13, 14):
        _equal(jout[i], tout[i], f"right plane {i}", rlive)


def test_distributed_join_counts(jmesh, tmesh):
    rng = np.random.default_rng(3)
    nl, nr = 800, 600
    lk = rng.integers(0, 100, nl)
    rk = rng.integers(0, 100, nr)
    jl, tl = _tables({"k": lk.tolist(), "lv": list(range(nl))}, jmesh, tmesh)
    jr, tr = _tables({"k": [None if i % 19 == 0 else int(k)
                            for i, k in enumerate(rk)],
                      "rv": list(range(nr))}, jmesh, tmesh)
    jout = jspmd.make_distributed_join_counts(jmesh, 1, 1)(
        *_join_inputs((jl, jr)))
    tout = tspmd.make_distributed_join_counts(tmesh, 1, 1)(
        *_join_inputs((tl, tr)))
    _join_equal(jout, tout, jl.shard_capacity, jr.shard_capacity)
    cl = collections.Counter(lk.tolist())
    cr = collections.Counter(int(k) for i, k in enumerate(rk) if i % 19)
    assert int(tout[0].sum()) == sum(cl[k] * cr.get(k, 0) for k in cl)


@pytest.mark.parametrize("salt", [1, 4])
def test_skew_aware_salted_join(jmesh, tmesh, salt):
    """80 % of probe rows share one key: the salted exchange gives the same
    totals while spreading probe rows over shards."""
    rng = np.random.default_rng(11)
    nl, nr = 1600, 100
    lk = np.where(rng.random(nl) < 0.8, 7, rng.integers(0, 50, nl))
    rk = np.arange(nr) % 50
    jl, tl = _tables({"k": lk.tolist(), "lv": list(range(nl))}, jmesh, tmesh)
    jr, tr = _tables({"k": rk.tolist(), "rv": list(range(nr))}, jmesh, tmesh)
    jout = jspmd.make_distributed_join_counts(
        jmesh, 1, 1, salt=salt, recv_factor=None)(*_join_inputs((jl, jr)))
    tout = tspmd.make_distributed_join_counts(
        tmesh, 1, 1, salt=salt, recv_factor=None)(*_join_inputs((tl, tr)))
    _join_equal(jout, tout, jl.shard_capacity, jr.shard_capacity)
    cl = collections.Counter(lk.tolist())
    cr = collections.Counter(rk.tolist())
    assert int(tout[0].sum()) == sum(cl[k] * cr.get(k, 0) for k in cl)
    if salt > 1:
        assert int(tout[1].max()) < 0.55 * int((lk == 7).sum())


@pytest.mark.parametrize("salt,factor", [(1, None), (1, 2.0), (4, 2.0),
                                         (1, 1.125)])
def test_bounded_recv_capacity_and_overflow_flag(jmesh, tmesh, salt, factor):
    """recv_factor bounds the receive planes; the overflow output trips
    when a hot key exceeds the bound, equal to JAX's, and salting spreads
    the key so it fits again."""
    nl, nr = 1600, 100
    jl, tl = _tables({"k": [7] * nl, "lv": list(range(nl))}, jmesh, tmesh)
    jr, tr = _tables({"k": (np.arange(nr) % 50).tolist(),
                      "rv": list(range(nr))}, jmesh, tmesh)
    jout = jspmd.make_distributed_join_counts(
        jmesh, 1, 1, salt=salt, recv_factor=factor)(*_join_inputs((jl, jr)))
    tout = tspmd.make_distributed_join_counts(
        tmesh, 1, 1, salt=salt, recv_factor=factor)(*_join_inputs((tl, tr)))
    _join_equal(jout, tout, jl.shard_capacity, jr.shard_capacity)
    ovf = int(tout[-1].sum())
    if factor is None or salt > 1:
        assert ovf == 0 and int(tout[0].sum()) == nl * 2
    else:
        assert ovf > 0


def _overlap_inputs(seed, per=1 << 9):
    rng = np.random.default_rng(seed)
    rows = per * N_DEV
    key = rng.integers(-300, 500, rows)
    kv = rng.random(rows) > 0.1
    val = rng.integers(-(2 ** 62), 2 ** 62, rows)  # sums wrap mod 2^64
    shard_rows = np.full(N_DEV, per - 7, np.int64)
    shard_rows[-1] = per // 3
    return key, kv, val, shard_rows


def test_overlapped_exchange_aggregate_matches_sequential(jmesh, tmesh):
    key, kv, val, shard_rows = _overlap_inputs(9)
    js, jc = j_overlapped(jmesh, n_chunks=4)(jnp.asarray(key),
                                            jnp.asarray(kv),
                                            jnp.asarray(val), shard_rows)
    tin = [torch.as_tensor(x) for x in (key, kv, val)]
    ts, tc = t_overlapped(tmesh, n_chunks=4)(*tin, shard_rows)
    _equal(js, ts, "overlapped sums")
    _equal(jc, tc, "overlapped counts")
    assert tc.dtype == torch.int32
    exch, agg = t_sequential(tmesh)
    ss, sc = agg(*exch(*tin, shard_rows))
    jexch, jagg = j_sequential(jmesh)
    jss, jsc = jagg(*jexch(jnp.asarray(key), jnp.asarray(kv),
                           jnp.asarray(val), shard_rows))
    _equal(jss, ss, "sequential sums")
    _equal(jsc, sc, "sequential counts")
    assert torch.equal(ss, ts) and torch.equal(sc, tc)


def test_global_dictionary_merge_distributed_groupby_orderby(jmesh, tmesh):
    """Shards ingest disjoint string sets with dictionaries of their own;
    after the global merge and the recode, a distributed GROUP BY and
    ORDER BY on the codes equal JAX's and decode to the right strings."""
    cap = 128
    rng = np.random.default_rng(21)
    pool = [f"city_{i:03d}" for i in range(40)]
    shard_vals = []
    for s in range(N_DEV):
        mine = pool[5 * s: 5 * s + 5]
        vals = [mine[rng.integers(0, 5)] for _ in range(100)]
        vals[s] = None
        shard_vals.append(vals)
    jcodes, jvalid, jrows, jdict = j_ingest(jmesh, shard_vals, cap)
    tcodes, tvalid, trows, tdict = t_ingest(tmesh, shard_vals, cap)
    # a NULL is encoded as "" in its shard's dictionary, in both
    assert list(tdict.values) == list(jdict.values) == [""] + sorted(pool)
    assert np.array_equal(trows, jrows)
    _equal(jvalid, tvalid, "validity")
    _equal(jcodes, tcodes, "codes", _np(jvalid))

    jprog = jspmd.make_distributed_aggregate(jmesh, [("count_star", 0)], 1,
                                             group_capacity=64)
    tprog = tspmd.make_distributed_aggregate(tmesh, [("count_star", 0)], 1,
                                             group_capacity=64)
    zeros = np.zeros(cap * N_DEV, np.int64)
    ones = np.ones(cap * N_DEV, bool)
    jout = jprog(jcodes, jvalid, jrows, jnp.asarray(zeros), jnp.asarray(ones))
    tout = tprog(tcodes, tvalid, trows, torch.as_tensor(zeros),
                 torch.as_tensor(ones))
    _agg_outputs_equal(jout, tout, 1, 1)
    per = tout[0].shape[0] // N_DEV
    got = {}
    for s in range(N_DEV):
        for i in range(int(tout[-1][s])):
            j = s * per + i
            name = tdict[int(tout[0][j])] if bool(tout[1][j]) else None
            assert name not in got, "group split across shards"
            got[name] = int(tout[2][j])
    assert got == dict(collections.Counter(v for vs in shard_vals
                                           for v in vs))

    jsort = jspmd.make_distributed_sort(jmesh, n_cols=0)(jcodes, jvalid,
                                                         jrows)
    tsort = tspmd.make_distributed_sort(tmesh, n_cols=0)(tcodes, tvalid,
                                                         trows)
    _sort_equal(jsort, tsort, 0)
    per_s = tsort[0].shape[0] // N_DEV
    got = []
    for s in range(N_DEV):
        c = int(tsort[-2][s])
        codes = tsort[0][s * per_s: s * per_s + c].numpy()
        ok = tsort[1][s * per_s: s * per_s + c].numpy()
        got += [tdict[int(x)] if v else None for x, v in zip(codes, ok)]
    live = sorted(v for vs in shard_vals for v in vs if v is not None)
    assert got == live + [None] * N_DEV


# ---------------------------------------------------------------------------
# the runner: collectives, failures, the card's route for grouped sums
# ---------------------------------------------------------------------------


def test_collectives(tmesh):
    def body(x, whole):
        me = tspmd.axis_index("data")
        a2a = tspmd.all_to_all(x * 10 + me, "data")
        return (a2a, tspmd.all_gather(x[:1], "data").reshape(-1),
                tspmd.psum(whole * me, "data"),
                tspmd.pmax(whole * me, "data"), torch.tensor([me]))

    x = torch.arange(N_DEV * N_DEV, dtype=torch.int64)
    whole = torch.tensor([1, 2])
    a2a, gathered, s, m, idx = tspmd.shard_map(
        body, tmesh, (P("data"), P()),
        (P("data"), P("data"), P(), P(), P("data")))(x, whole)
    blocks = (x * 10).reshape(N_DEV, N_DEV) + torch.arange(N_DEV)[:, None]
    assert torch.equal(a2a.reshape(N_DEV, N_DEV), blocks.T)
    assert torch.equal(gathered, torch.arange(0, N_DEV * N_DEV,
                                              N_DEV).repeat(N_DEV))
    assert s.tolist() == [28, 56] and m.tolist() == [7, 14]
    assert idx.tolist() == list(range(N_DEV))
    assert tmesh.stats["runs"] >= 1 and tmesh.stats["collectives"] >= 4


def _run_bounded(fn, seconds=60):
    """Run fn in a thread; fail if it does not end in time."""
    box = {}

    def target():
        try:
            fn()
        except BaseException as e:  # handed to the test below
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "shard_map hung"
    return box.get("error")


def test_a_raising_shard_does_not_hang(tmesh):
    def body(x):
        if tspmd.axis_index("data") == 3:
            raise ValueError("shard 3 failed")
        return tspmd.all_to_all(x, "data")

    run = tspmd.shard_map(body, tmesh, (P("data"),), P("data"))
    err = _run_bounded(lambda: run(torch.arange(N_DEV * N_DEV)))
    assert isinstance(err, ValueError) and "shard 3" in str(err)


def test_mismatched_collectives_raise(tmesh):
    def body(x):
        me = tspmd.axis_index("data")
        if me == 0:
            return tspmd.all_gather(x, "data").reshape(-1)[:N_DEV]
        if me == 1:
            return x  # returns while the others wait in a collective
        return tspmd.all_to_all(x, "data")

    run = tspmd.shard_map(body, tmesh, (P("data"),), P("data"))
    err = _run_bounded(lambda: run(torch.arange(N_DEV * N_DEV)))
    assert isinstance(err, DistributedError)


def test_collective_outside_shard_map_raises():
    with pytest.raises(DistributedError):
        tspmd.axis_index("data")


@pytest.fixture()
def card_route(monkeypatch):
    """group_agg's card route on CPU tensors (the kernel stood in by its
    plain version), and a spy on every grouped accumulator of the CPU."""
    calls = collections.Counter()
    lock = threading.Lock()
    in_kernel = threading.local()  # the stand-in's own index_add_s

    def kernel(items, gid, num_groups):
        with lock:
            calls["kernel"] += 1
        in_kernel.on = True
        try:
            return tga.accumulate_plain(items, gid, num_groups)
        finally:
            in_kernel.on = False

    monkeypatch.setattr(tga, "on_card", lambda t: True)
    monkeypatch.setattr(tga, "accumulate_kernel", kernel)
    for obj, name in ((torch.Tensor, "index_add_"), (torch.Tensor,
                                                     "index_add"),
                      (torch, "index_add"), (torch.Tensor, "scatter_add_"),
                      (torch, "bincount")):
        fn = getattr(obj, name)

        def counted(*a, _fn=fn, _name=name, **k):
            if not getattr(in_kernel, "on", False):
                with lock:
                    calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(obj, name, counted)
    return calls


def test_grouped_sums_take_group_agg(jmesh, tmesh, card_route):
    """On the card's route the aggregates, join counts and bucket sums go
    to group_agg; no index_add_, scatter_add_ or bincount runs; results
    equal JAX's."""
    rng = np.random.default_rng(31)
    data = {"k": rng.integers(0, 90, 1000).tolist(),
            "x": np.round(rng.normal(0, 100, 1000), 3).tolist()}
    jt, tt = _tables(data, jmesh, tmesh)
    aggs = [("count_star", -1), ("sum", 0), ("avg", 0)]
    jout = jspmd.make_distributed_aggregate(jmesh, aggs, 1)(
        *_args(jt, ([0], [1])))
    tout = tspmd.make_distributed_aggregate(tmesh, aggs, 1)(
        *_args(tt, ([0], [1])))
    _agg_outputs_equal(jout, tout, 1, 4)
    after_agg = card_route["kernel"]
    key, kv, val, shard_rows = _overlap_inputs(12)
    ts, tc = t_overlapped(tmesh, n_chunks=4)(
        *[torch.as_tensor(x) for x in (key, kv, val)], shard_rows)
    js, jc = j_overlapped(jmesh, n_chunks=4)(jnp.asarray(key),
                                            jnp.asarray(kv),
                                            jnp.asarray(val), shard_rows)
    _equal(js, ts, "sums")
    _equal(jc, tc, "counts")
    assert after_agg >= 2 * N_DEV  # partial and final on every shard
    assert card_route["kernel"] - after_agg == 4 * N_DEV  # a chunk each
    assert not {k: v for k, v in card_route.items() if k != "kernel"}


def test_make_mesh_without_cuda_raises(monkeypatch):
    """make_mesh() takes the CUDA devices; with none it raises and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DistributedError, match="no CUDA device"):
        t_make_mesh()
    mesh = t_make_mesh(["cpu"] * 3, axis="rows")
    assert mesh.size == 3 and mesh.home == torch.device("cpu")
    assert mesh.local == [0, 1, 2] and not mesh.process_group


def test_collectives_stress_many_shards():
    """More shards than cores, a short switch interval: every round's
    all-to-all and psum are right, and the mesh's counters, which every
    shard updates, lose no update."""
    import os
    import sys

    n = min(max(16, 2 * (os.cpu_count() or 1)), 48)
    mesh = t_make_mesh(["cpu"] * n)
    rounds = 20

    def body(x):
        me = tspmd.axis_index("data")
        for r in range(rounds):
            got = tspmd.all_to_all(x + r, "data")
            want = torch.arange(n, dtype=torch.int64) * n + me + r
            if not torch.equal(got, want):
                raise AssertionError(f"shard {me} round {r}: {got}")
            total = tspmd.psum(torch.tensor([me + r]), "data")
            if int(total) != n * (n - 1) // 2 + n * r:
                raise AssertionError(f"shard {me} round {r}: psum {total}")
        return x[:1]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run = tspmd.shard_map(body, mesh, (P("data"),), P("data"))
        box = {}
        err = _run_bounded(lambda: box.setdefault(
            "out", run(torch.arange(n * n, dtype=torch.int64))), 120)
    finally:
        sys.setswitchinterval(old)
    assert err is None, err
    assert box["out"].tolist() == [i * n for i in range(n)]
    assert mesh.stats["collectives"] == 2 * rounds
    # each shard receives n - 1 foreign int64s a round
    assert mesh.stats["bytes_exchanged"] == rounds * n * (n - 1) * 8


def test_float_sums_hold_rtol_on_the_card_route(jmesh, tmesh, card_route):
    """Signed float values whose group sums cancel: on the card's route
    the distributed SUM and AVG (two fixed-point words a float item)
    stay within rtol 1e-9 of JAX's float64 sums, partial and final."""
    rng = np.random.default_rng(17)
    pairs = 2000  # adjacent rows a, -a + d of one key: sums near d
    a = np.round(rng.normal(0, 1e4, pairs), 3)
    d = np.round(rng.uniform(0.1, 1.0, pairs), 3)
    x = np.stack([a, -a + d], axis=1).reshape(-1)
    x[rng.permutation(2 * pairs)[:3]] = [np.inf, -np.inf, np.nan]
    keys = np.repeat(rng.integers(0, 700, pairs), 2)
    data = {"k": keys.tolist(), "x": x.tolist()}
    jt, tt = _tables(data, jmesh, tmesh)
    aggs = [("sum", 0), ("avg", 0), ("count", 0)]
    jout = jspmd.make_distributed_aggregate(jmesh, aggs, 1)(
        *_args(jt, ([0], [1])))
    tout = tspmd.make_distributed_aggregate(tmesh, aggs, 1)(
        *_args(tt, ([0], [1])))
    _agg_outputs_equal(jout, tout, 1, 4)
    assert card_route["kernel"] >= 2 * N_DEV


def test_two_words_split_exactly():
    rng = np.random.default_rng(6)
    x = torch.as_tensor(np.concatenate([rng.normal(0, 1e6, 500),
                                        [np.inf, -np.inf, np.nan, 0.0]]))
    ok = torch.as_tensor(rng.random(504) > 0.1)
    hi, lo = tga.two_words(x, ok)
    fin = (ok & torch.isfinite(x)).numpy()
    assert np.array_equal((hi + lo).numpy()[fin], x.numpy()[fin])
    # hi lies on a grid the kernel's quantization of hi holds exactly
    q, inv = tga.quantize(hi, ok)
    assert torch.equal(q.to(torch.float64)[fin] * inv, hi[fin])
    assert float(hi[500]) == np.inf and float(hi[501]) == -np.inf
    assert np.isnan(float(hi[502])) and float(lo[500:503].abs().sum()) == 0
    assert float(lo.abs().max()) <= float(inv) * 2
