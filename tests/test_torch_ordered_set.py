"""The ordered-set aggregates (PERCENTILE_CONT, PERCENTILE_DISC, MEDIAN,
MODE() WITHIN GROUP) in the port against the JAX package.

* The SQL cases of tests/test_statistics_aggs.py's ordered-set tests and
  tests/test_filter_clause.py's percentile case (their mesh cases stay
  out), and tables with NaN, -NaN, -0.0, +-inf, NULLs, all-NULL groups and
  ties, run through the JAX Session and the port's `Session(device="cpu")`:
  with the compiled pipeline on, with it off (QE_COMPILED=0), and with the
  pipeline admitting nodes as on CUDA (`_graphs = True`, `_capture`
  stubbed). Rows must be equal and in the same order: integers exactly,
  floats to rtol 1e-9. Where the JAX package raises, the port raises the
  same error class.
* A function-level differential: the JAX executor's `_grouped_percentile`
  and the port's on the same planes (made from a numpy seed), for CONT,
  DISC and MODE, fractions 0, 0.25, 0.5 and 1, ASC and DESC. DISC and
  MODE must give the same values exactly, CONT to rtol 1e-9. lax.sort's
  comparator makes -0.0 equal to 0.0 and every NaN equal to every other
  (and the JAX package's sort is not stable), so there a -0.0 may stand
  for a 0.0 and a NaN for a NaN of the other sign.
* The quantiles over one plane share one sort.
"""

import math
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.executor import QueryExecutor as JExecutor
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu.plan import logical as jlp
from query_engine_tpu_torch.engine.executor import QueryExecutor
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.tpch import oracle

# tests/test_statistics_aggs.py's table, drawn in its order
RNG = np.random.default_rng(11)
N = 3000
SK = RNG.integers(0, 25, N)
SV = RNG.normal(50, 12, N).round(5)
SVNULL = RNG.random(N) < 0.07
SIV = RNG.integers(-40, 900, N)

# tests/test_filter_clause.py's table
FRNG = np.random.default_rng(23)
FK = FRNG.integers(0, 12, 2000)
FV = FRNG.normal(0, 30, 2000).round(4)
FVNULL = FRNG.random(2000) < 0.08

NAN, NNAN, INF = float("nan"), -float("nan"), float("inf")


def _register(s):
    s.register_table("t", {
        "k": SK.tolist(),
        "v": [None if b else float(x) for x, b in zip(SV, SVNULL)],
        "iv": SIV.tolist(),
    })
    s.register_table("ft", {
        "k": FK.tolist(),
        "v": [None if b else float(x) for x, b in zip(FV, FVNULL)],
    })
    s.register_table("e1", {"g": [1, 1, 1, 1], "x": [10, 20, 30, 40]})
    s.register_table("e2", {"k": [1, 2, 2, 3], "v": [5.0, 1.0, 4.0, None]})
    s.register_table("e3", {"g": [1] * 4 + [2], "v": [1, 1, 2, 2, None]})
    # NaN, -NaN, -0.0, 0.0, +-inf, NULLs, ties; group 5 is all NULL
    s.register_table("nz", {
        "g": [1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 5, 5],
        "v": [NAN, 1.0, NAN, 2.0, 2.0, None, -0.0, 0.0, -0.0, 3.0,
              INF, -INF, NNAN, 7.5, -INF, 0.0, -0.0, None, None, None],
        "i": [3, 3, 1, 1, 2, None, 9, -9, 9, -9, 0, 0, 0, 5, 5, 7, None, 7,
              None, None],
    })


CASES = [
    # tests/test_statistics_aggs.py
    "SELECT k, MEDIAN(v), PERCENTILE_CONT(0.25) WITHIN GROUP (ORDER BY v), "
    "PERCENTILE_CONT(0.25) WITHIN GROUP (ORDER BY v DESC), "
    "PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY v) "
    "FROM t GROUP BY k ORDER BY k",
    "SELECT PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY x), "
    "PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY x DESC), "
    "PERCENTILE_DISC(0.0) WITHIN GROUP (ORDER BY x), "
    "PERCENTILE_DISC(1.0) WITHIN GROUP (ORDER BY x) FROM e1",
    "SELECT k, MEDIAN(v), MEDIAN(v) * 10 FROM e2 GROUP BY k ORDER BY k",
    "SELECT MEDIAN(v) FROM e2 WHERE v > 99",
    "SELECT k FROM e2 GROUP BY k HAVING MEDIAN(v) > 3 ORDER BY k",
    "SELECT k, MODE() WITHIN GROUP (ORDER BY iv % 10) "
    "FROM t GROUP BY k ORDER BY k",
    "SELECT g, MODE() WITHIN GROUP (ORDER BY v), "
    "MODE() WITHIN GROUP (ORDER BY v DESC) FROM e3 GROUP BY g ORDER BY g",
    "SELECT MODE() WITHIN GROUP (ORDER BY v) FROM e3 WHERE v > 9",
    # tests/test_filter_clause.py
    "SELECT k, STDDEV_POP(v) FILTER (WHERE v > 0) AS sd, "
    "MEDIAN(v) FILTER (WHERE v > 0) AS md, "
    "CORR(v, k) FILTER (WHERE v > 0) AS cr FROM ft GROUP BY k ORDER BY k",
    # NaN, -0.0, infinities, NULLs, ties, an all-NULL group
    "SELECT g, MEDIAN(v), PERCENTILE_CONT(0.25) WITHIN GROUP (ORDER BY v), "
    "PERCENTILE_CONT(1.0) WITHIN GROUP (ORDER BY v DESC), "
    "PERCENTILE_DISC(0.25) WITHIN GROUP (ORDER BY v), "
    "PERCENTILE_DISC(0.75) WITHIN GROUP (ORDER BY v DESC), "
    "MODE() WITHIN GROUP (ORDER BY v), "
    "MODE() WITHIN GROUP (ORDER BY v DESC) FROM nz GROUP BY g ORDER BY g",
    "SELECT g, MEDIAN(i), PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY i), "
    "MODE() WITHIN GROUP (ORDER BY i), "
    "MODE() WITHIN GROUP (ORDER BY i DESC), COUNT(*), SUM(i) "
    "FROM nz GROUP BY g ORDER BY g",
    "SELECT MEDIAN(v), MODE() WITHIN GROUP (ORDER BY i DESC), "
    "PERCENTILE_DISC(0.0) WITHIN GROUP (ORDER BY v DESC) FROM nz",
    # in a derived table, ORDER BY and a join
    "SELECT d.k, d.m FROM (SELECT k, MEDIAN(v) AS m FROM t GROUP BY k) d "
    "WHERE d.m > 50 ORDER BY d.m DESC LIMIT 5",
    "SELECT t.k, COUNT(*), MEDIAN(t.iv) FROM t JOIN e2 ON t.k = e2.k "
    "GROUP BY t.k ORDER BY t.k",
]

# the JAX package raises these; the port must raise the same class
RAISING = [
    "SELECT PERCENTILE_CONT(1.5) WITHIN GROUP (ORDER BY v) FROM t",
    "SELECT MEDIAN(CAST(k AS VARCHAR)) FROM t",
    "SELECT PERCENTILE_CONT(v) WITHIN GROUP (ORDER BY v) FROM t",
    "SELECT MEDIAN(DISTINCT v) FROM t",
]


def _run(s, sql):
    try:
        return s.sql(sql).to_pylist()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__


@pytest.fixture(scope="module")
def jax_results():
    js = JSession()
    _register(js)
    return {sql: _run(js, sql) for sql in CASES + RAISING}


MODES = ["compiled", "QE_COMPILED=0", "graphs"]


def _session(mode):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
    _register(s)
    return s


@pytest.fixture(scope="module")
def sessions():
    return {mode: _session(mode) for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", CASES, ids=range(len(CASES)))
def test_case_matches_jax(jax_results, sessions, sql, mode):
    want = jax_results[sql]
    assert not isinstance(want, str), want
    s = sessions[mode]
    oracle.compare(s.sql(sql).to_pylist(), want)
    pipe = s.executor.pipeline
    if mode == "QE_COMPILED=0":
        assert pipe.stats["compiles"] == 0, pipe.stats
    else:
        assert pipe.stats["fallbacks"] == 0, pipe.stats


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", RAISING, ids=range(len(RAISING)))
def test_case_raises_as_in_jax(jax_results, sessions, sql, mode):
    want = jax_results[sql]
    assert isinstance(want, str) and want != "NotImplementedError", want
    assert _run(sessions[mode], sql) == want


def test_percentiles_against_numpy(jax_results):
    """test_statistics_aggs.py's check: MEDIAN and CONT(0.25) as
    np.percentile, CONT(0.25) DESC as CONT(0.75), DISC(0.5) as the
    ceil(c/2)-th value."""
    rows = _session("compiled").sql(CASES[0]).to_pylist()
    oracle.compare(rows, jax_results[CASES[0]])
    for g, med, q25, q25d, d50 in rows:
        a = np.sort(SV[(SK == g) & ~SVNULL])
        assert med == pytest.approx(np.percentile(a, 50), rel=1e-9)
        assert q25 == pytest.approx(np.percentile(a, 25), rel=1e-9)
        assert q25d == pytest.approx(np.percentile(a, 75), rel=1e-9)
        assert d50 == a[int(np.ceil(0.5 * len(a))) - 1]


def test_quantiles_over_one_plane_share_one_sort(monkeypatch):
    """MEDIAN, CONT(0.9) and CONT(0.25) DESC of one column sort it once;
    DISC and MODE of it share a second sort (their values keep the
    column's type); another column sorts again."""
    sorts = []
    real = K.sort_by_group_value

    def counted(*args):
        sorts.append(args[0].dtype)
        return real(*args)

    monkeypatch.setattr(K, "sort_by_group_value", counted)
    s = _session("compiled")
    s.sql("SELECT k, MEDIAN(iv), "
          "PERCENTILE_CONT(0.9) WITHIN GROUP (ORDER BY iv), "
          "PERCENTILE_CONT(0.25) WITHIN GROUP (ORDER BY iv DESC) "
          "FROM t GROUP BY k").to_pylist()
    assert sorts == [torch.float64]
    sorts.clear()
    s.sql("SELECT k, PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY iv), "
          "MODE() WITHIN GROUP (ORDER BY iv DESC), MEDIAN(iv), MEDIAN(v) "
          "FROM t GROUP BY k").to_pylist()
    assert sorted(map(str, sorts)) == ["torch.float64", "torch.float64",
                                       "torch.int64"]


# ---- function-level differential ------------------------------------------

CAP, NUM_ROWS, OUT_CAP, GROUPS = 512, 470, 128, 9


def _planes(kind, seed):
    """Values, validity and group ids of CAP rows (NUM_ROWS live): ties,
    NULLs, group 7 all NULL, group 8 empty, groups 9.. unused."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, GROUPS - 1, CAP).astype(np.int64)
    valid = rng.random(CAP) > 0.15
    valid[gid == 7] = False
    if kind == "float":
        vals = rng.choice([-2.5, -1.0, 0.0, 0.5, 0.5, 1.0, 3.25], CAP)
        special = rng.random(CAP)
        vals = np.where(special < 0.06, np.nan, vals)
        vals = np.where((special > 0.06) & (special < 0.10), -np.nan, vals)
        vals = np.where((special > 0.10) & (special < 0.16), -0.0, vals)
        vals = np.where((special > 0.16) & (special < 0.19), np.inf, vals)
        vals = np.where((special > 0.19) & (special < 0.21), -np.inf, vals)
        vals = np.where(special > 0.6, vals + rng.normal(0, 1, CAP), vals)
    else:
        vals = rng.integers(-6, 6, CAP).astype(np.int64)
    return vals, valid, gid


def _jax_run(func, frac, desc, vals, valid, gid, cache):
    agg = types.SimpleNamespace(func=getattr(jlp.AggFunc, func),
                                param=(frac, desc))
    out, ok = JExecutor()._grouped_percentile(
        agg, vals, valid, gid, NUM_ROWS, CAP, OUT_CAP, cache)
    return np.asarray(out), np.asarray(ok)


def _port_run(func, frac, desc, vals, valid, gid, cache):
    agg = types.SimpleNamespace(func=getattr(lp.AggFunc, func),
                                param=(frac, desc))
    out, ok = QueryExecutor("cpu")._grouped_percentile(
        agg, vals, valid, gid, NUM_ROWS, CAP, OUT_CAP, cache)
    return out.numpy(), ok.numpy()


FUNCS = [(f, frac, desc)
         for f in ("PERCENTILE_CONT", "PERCENTILE_DISC")
         for frac in (0.0, 0.25, 0.5, 1.0) for desc in (False, True)] \
    + [("MODE", None, False), ("MODE", None, True)]


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("func,frac,desc", FUNCS)
def test_grouped_percentile_matches_jax(kind, func, frac, desc):
    planes = _planes(kind, seed=5 if kind == "float" else 6)
    vals = planes[0]
    want, want_ok = _jax_run(func, frac, desc, *map(jnp.asarray, planes),
                             {})
    got, got_ok = _port_run(func, frac, desc,
                            *map(torch.from_numpy, planes), {})
    assert got.shape == want.shape == (OUT_CAP,)
    np.testing.assert_array_equal(got_ok, want_ok)
    assert want_ok[:7].all() and not want_ok[7:].any()
    g, w = got[got_ok], want[want_ok]
    if func == "PERCENTILE_CONT":
        assert got.dtype == np.float64
        both_nan = np.isnan(g) & np.isnan(w)
        assert np.array_equal(np.isnan(g), np.isnan(w)), (g, w)
        assert np.allclose(g[~both_nan], w[~both_nan], rtol=1e-9, atol=0.0)
        return
    assert got.dtype == want.dtype == vals.dtype
    assert np.array_equal(g, w, equal_nan=kind == "float"), (g, w)


def test_planted_values_are_reached():
    """The float planes hold every special value the differential is
    about, inside live valid rows, with ties."""
    vals, valid, gid = _planes("float", seed=5)
    live = vals[:NUM_ROWS][valid[:NUM_ROWS]]
    bits = live.view(np.int64)
    assert (np.isnan(live) & (bits < 0)).any()
    assert (np.isnan(live) & (bits > 0)).any()
    assert ((live == 0) & (bits < 0)).any() and ((live == 0) & (bits == 0)).any()
    assert np.isinf(live).any() and (live == -np.inf).any()
    assert len(np.unique(live[np.isfinite(live)])) < len(live)


def test_shared_sort_gives_the_same_results():
    """A cache hit (the second quantile over one plane) gives what a
    fresh sort gives, in both packages."""
    planes = _planes("float", seed=7)
    jplanes = list(map(jnp.asarray, planes))
    pplanes = list(map(torch.from_numpy, planes))
    jcache, pcache = {}, {}
    for frac in (0.5, 0.9, 0.25):
        want, _ = _jax_run("PERCENTILE_CONT", frac, False, *jplanes, jcache)
        got, ok = _port_run("PERCENTILE_CONT", frac, False, *pplanes, pcache)
        fresh, _ = _port_run("PERCENTILE_CONT", frac, False, *pplanes, {})
        assert np.array_equal(got, fresh, equal_nan=True)
        assert np.allclose(got[ok], want[ok], rtol=1e-9, atol=0.0,
                           equal_nan=True)
    assert len(pcache) == len(jcache) == 1


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_total_order_key_matches_lax_sort(dtype):
    """The sort key orders floats as lax.sort does: NaNs of either sign
    last and equal, -0.0 equal to 0.0."""
    x = np.array([np.nan, 1.0, -0.0, 0.0, -np.nan, np.inf, -np.inf, -1.0,
                  -0.0, 2.5, -3e38], dtype=dtype)
    want = np.asarray(jnp.sort(jnp.asarray(x)))
    key = K.total_order_key(torch.from_numpy(x))
    order = torch.sort(key, stable=True).indices.numpy()
    assert np.array_equal(x[order], want, equal_nan=True)
    key = key.numpy()
    assert key[2] == key[3] == key[8] and key[0] == key[4] > key[5]
    assert all(math.isnan(v) for v in x[order][-2:])
