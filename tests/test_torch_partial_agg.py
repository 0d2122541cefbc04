"""The partial/final aggregate decomposition of the port
(`query_engine_tpu_torch/engine/partial_agg.py` and the executor's
`partial` and `final` modes) against the JAX package's, on the same
seeded numpy inputs.

* `partial_eligible` gives the JAX package's answer for every aggregate
  list of the cases (DISTINCT, statistics and DECIMAL ones among them);
* `build_partial_final` gives the same three plans: the partial aggregate
  (AVG split into SUM and COUNT), the final combine over its columns by
  position, and the output projection (AVG as sum / NULLIF(count, 0));
* a `partial` aggregate gives the JAX package's planes, AVG's float64 sum
  and int64 count pair included, and a `final` aggregate over them gives
  the JAX package's rows and the single-pass aggregate's, in the eager
  executor, grouped and global, with NULL keys and NULL values;
* on the card's route (emulated on the CPU: group_agg's kernel stood in by
  its plain version) partial and final aggregates launch group_agg and
  give the same rows;
* the compiled pipeline keeps running partial and final aggregates in the
  eager executor, as the JAX one does.

Integers exactly, floats to rtol 1e-9.
"""

import math

import numpy as np
import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.engine import partial_agg as jpa
from query_engine_tpu.engine.executor import (
    QueryExecutor as JExecutor, _Materialized as JMat,
)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu.plan import logical as jlp
from query_engine_tpu.plan import physical as jpp
from query_engine_tpu.plan.lowering import Lowering as JLowering
from query_engine_tpu.sql.parser import parse_sql as jparse
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine import partial_agg as tpa
from query_engine_tpu_torch.engine.executor import (
    QueryExecutor, _Materialized,
)
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import group_agg as tga
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp
from query_engine_tpu_torch.plan.lowering import Lowering
from query_engine_tpu_torch.sql.parser import parse_sql

RTOL = 1e-9


def _table(n=700, seed=11):
    rng = np.random.default_rng(seed)
    t = {"k": rng.integers(0, 23, n).tolist(),
         "j": rng.integers(-3, 3, n).tolist(),
         "v": rng.integers(-1000, 1000, n).tolist(),
         "x": np.round(rng.normal(5, 20, n), 3).tolist(),
         "s": rng.choice(["ant", "bee", "cat", "dog"], n).tolist()}
    for i in range(0, n, 13):
        t["v"][i] = None
    for i in range(0, n, 29):
        t["k"][i] = None
    for i in range(0, n, 41):
        t["x"][i] = None
    return t


TABLE = _table()
DECIMAL = "CREATE TABLE dm (k INT, p DECIMAL(10, 2))"

# aggregate lists over t (the SELECT lists of the cases)
AGGS = [
    "k, COUNT(*), SUM(v), AVG(v), MIN(v), MAX(v)",
    "k, COUNT(v), SUM(x), AVG(x), MIN(x), MAX(x), MIN(s), MAX(s)",
    "k, j, COUNT(*), SUM(v + j), AVG(x * 2)",
    "COUNT(*), SUM(v), AVG(x), MIN(s)",
    "k, COUNT(DISTINCT v)",
    "k, VAR_SAMP(v)",
    "s, AVG(v), MAX(x)",
]
GROUPS = {0: "k", 1: "k", 2: "k, j", 3: None, 4: "k", 5: "k", 6: "s"}


def _sql(i):
    g = GROUPS[i]
    return f"SELECT {AGGS[i]} FROM t" + (f" GROUP BY {g}" if g else "")


def _find_agg(plan, mod):
    node = plan
    while not isinstance(node, mod.PHashAggregate):
        node = node.input
    return node


def _plans(sql):
    """The lowered physical plan's aggregate node in both packages."""
    js = JSession()
    js.register_table("t", TABLE)
    ts = Session(device="cpu")
    ts.register_table("t", TABLE)
    jplan = JLowering(js.sources).lower(
        js.optimizer.optimize(js.planner.create_logical_plan(jparse(sql))))
    tplan = Lowering(ts.sources).lower(
        ts.optimizer.optimize(ts.planner.create_logical_plan(parse_sql(sql))))
    return (js, _find_agg(jplan, jpp)), (ts, _find_agg(tplan, pp))


def _sig(plan):
    """A package-free description of an aggregate or projection node."""
    schema = [(f.name, f.data_type.kind.name, bool(f.nullable))
              for f in plan.schema()]
    if hasattr(plan, "agg_exprs"):
        body = ([g.name() for g in plan.group_exprs],
                [(a.func.value, None if a.expr is None else a.expr.name(),
                  a.distinct) for a in plan.agg_exprs], plan.mode)
    else:
        body = [e.name() for e in plan.exprs]
    return schema, body


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=RTOL, abs_tol=0.0)
    return a == b and type(a) is type(b)


def _same_rows(got, want):
    key = lambda r: tuple((x is None, str(type(x)), x if x is not None  # noqa: E731
                           else 0) for x in r)
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want), (got[:3], want[:3])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w)), \
            (g, w)


@pytest.mark.parametrize("i", range(len(AGGS)))
def test_partial_eligible_matches_jax(i):
    (_, jagg), (_, tagg) = _plans(_sql(i))
    assert tpa.partial_eligible(tagg) == jpa.partial_eligible(jagg)


def test_decimal_not_eligible():
    js, ts = JSession(), Session(device="cpu")
    for s in (js, ts):
        s.sql(DECIMAL)
    jplan = JLowering(js.sources).lower(js.planner.create_logical_plan(
        jparse("SELECT k, SUM(p) FROM dm GROUP BY k")))
    tplan = Lowering(ts.sources).lower(ts.planner.create_logical_plan(
        parse_sql("SELECT k, SUM(p) FROM dm GROUP BY k")))
    assert not jpa.partial_eligible(_find_agg(jplan, jpp))
    assert not tpa.partial_eligible(_find_agg(tplan, pp))


@pytest.mark.parametrize("i", [0, 1, 2, 3, 6])
def test_build_partial_final_matches_jax(i):
    (_, jagg), (_, tagg) = _plans(_sql(i))
    jparts = jpa.build_partial_final(jagg)
    tparts = tpa.build_partial_final(tagg)
    assert [_sig(p) for p in tparts] == [_sig(p) for p in jparts]
    assert tparts[0].input is tagg.input and tparts[1].input is tparts[0]
    assert tpa.build_partial_final(tagg) is tparts  # cached on the node


def _split(batch_rows, n_parts, seed=3):
    """Row indices of n_parts random non-empty partitions."""
    rng = np.random.default_rng(seed)
    part = rng.integers(0, n_parts, batch_rows)
    return [np.nonzero(part == p)[0] for p in range(n_parts)]


def _modes(i):
    """Partial over three row partitions, then final over their concat, in
    both packages. Returns the partial rows and final rows of each, and
    the single-pass rows."""
    (js, jagg), (ts, tagg) = _plans(_sql(i))
    jin = JExecutor().execute(jagg.input)
    tex = QueryExecutor("cpu")
    tin = tex.execute(tagg.input)
    out = {}
    for pkg, agg, inp, ex, mod, mat, batch_cls in (
            ("jax", jagg, jin, JExecutor(), jpp, JMat, JBatch),
            ("torch", tagg, tin, tex, pp, _Materialized, ColumnBatch)):
        parts = []
        for rows in _split(inp.num_rows, 3):
            piece = inp.take_host(rows)
            node = mod.PHashAggregate(mat(piece), list(agg.group_exprs),
                                      list(agg.agg_exprs), mode="partial")
            parts.append(ex.execute(node))
        merged = batch_cls.concat(parts)
        g = len(agg.group_exprs)
        lpm = jlp if pkg == "jax" else lp
        refs = [lpm.ColumnRef(c, merged.schema.field(c).name,
                              merged.schema.field(c).data_type,
                              merged.schema.field(c).nullable)
                for c in range(g)]
        final = ex.execute(mod.PHashAggregate(
            mat(merged), refs, list(agg.agg_exprs), mode="final"))
        out[pkg] = ([p.to_pylist() for p in parts], final.to_pylist(),
                    [f.name for f in parts[0].schema],
                    [f.name for f in final.schema])
    single = ts.sql(_sql(i)).to_pylist()
    return out, single


@pytest.mark.parametrize("i", [0, 1, 2, 3, 6])
def test_partial_and_final_modes_match_jax(i):
    out, single = _modes(i)
    (jparts, jfinal, jnames, jfnames) = out["jax"]
    (tparts, tfinal, tnames, tfnames) = out["torch"]
    assert tnames == jnames and tfnames == jfnames
    if "AVG" in AGGS[i]:
        assert any(n.endswith("__sum") for n in tnames)
        assert any(n.endswith("__cnt") for n in tnames)
    for tp, jp in zip(tparts, jparts):
        _same_rows(tp, jp)
    _same_rows(tfinal, jfinal)
    _same_rows(tfinal, single)


@pytest.fixture()
def card_route(monkeypatch):
    """group_agg's card route on CPU tensors, the kernel stood in by its
    plain version; counts the stand-in launches."""
    calls = {"kernel": 0}
    plain = tga.accumulate_plain

    def kernel(items, gid, num_groups):
        calls["kernel"] += 1
        return plain(items, gid, num_groups)

    monkeypatch.setattr(tga, "on_card", lambda t: True)
    monkeypatch.setattr(tga, "accumulate_kernel", kernel)
    return calls


@pytest.mark.parametrize("i", [0, 1, 3, 6])
def test_partial_and_final_launch_group_agg_on_the_card_route(card_route, i):
    out, single = _modes(i)
    assert card_route["kernel"] > 0
    _same_rows(out["torch"][1], out["jax"][1])
    _same_rows(out["torch"][1], single)


def test_final_mode_combines_through_the_segment_route(card_route,
                                                       monkeypatch):
    """A final aggregate's COUNT and SUM partials and AVG's pair are the
    items of one group_agg call over the segment ids: they add. MIN and
    MAX take their extreme through `segment_aggregate`, whose NULL test is
    a group_agg count of its own."""
    from query_engine_tpu_torch.ops import kernels as TK

    funcs, multi = [], []
    real, real_multi = TK.segment_aggregate, tga.grouped_sums_counts_multi

    def spy(func, *args, **kwargs):
        funcs.append(func)
        return real(func, *args, **kwargs)

    def spy_multi(items, gid, num_groups):
        multi.append(len(items))
        return real_multi(items, gid, num_groups)

    (_, _), (ts, tagg) = _plans(_sql(0))
    tex = QueryExecutor("cpu")
    partial = tex.execute(pp.PHashAggregate(
        _Materialized(tex.execute(tagg.input)), list(tagg.group_exprs),
        list(tagg.agg_exprs), mode="partial"))
    monkeypatch.setattr(TK, "segment_aggregate", spy)
    monkeypatch.setattr(tga, "grouped_sums_counts_multi", spy_multi)
    launches = card_route["kernel"]
    f = partial.schema.field(0)
    out = tex.execute(pp.PHashAggregate(
        _Materialized(partial),
        [lp.ColumnRef(0, f.name, f.data_type, f.nullable)],
        list(tagg.agg_exprs), mode="final"))
    # the direct group ids' count; COUNT(*), SUM(v) and AVG(v)'s sum and
    # count in one call; MIN(v)'s and MAX(v)'s NULL tests
    assert funcs == ["min", "max"]
    assert multi == [1, 4, 1, 1]
    assert card_route["kernel"] - launches == 4
    _same_rows(out.to_pylist(), ts.sql(_sql(0)).to_pylist())


def test_partial_avg_takes_sum_and_count_from_one_call(card_route,
                                                       monkeypatch):
    """A partial AVG off the group_agg item route (a float key: no dense
    bound, so the segment route) takes its sum and count planes from one
    group_agg call."""
    multi = []
    real_multi = tga.grouped_sums_counts_multi

    def spy_multi(items, gid, num_groups):
        multi.append(len(items))
        return real_multi(items, gid, num_groups)

    sql = "SELECT x, AVG(v) AS a FROM t GROUP BY x"
    ts = Session(device="cpu")
    ts.register_table("t", TABLE)
    tagg = _find_agg(Lowering(ts.sources).lower(ts.optimizer.optimize(
        ts.planner.create_logical_plan(parse_sql(sql)))), pp)
    tex = QueryExecutor("cpu")
    inp = tex.execute(tagg.input)
    monkeypatch.setattr(tga, "grouped_sums_counts_multi", spy_multi)
    launches = card_route["kernel"]
    partial = tex.execute(pp.PHashAggregate(
        _Materialized(inp), list(tagg.group_exprs), list(tagg.agg_exprs),
        mode="partial"))
    assert multi == [1] and card_route["kernel"] - launches == 1
    want = {}
    for k, v in zip(TABLE["x"], TABLE["v"]):
        s, c = want.get(k, (0, 0))
        want[k] = (s + (v or 0), c + (v is not None))
    got = {r[0]: r[1:] for r in partial.to_pylist()}
    assert got.keys() == want.keys()
    for k, (s, c) in want.items():
        assert got[k][1] == c  # the count, exactly
        assert (got[k][0] is None) == (c == 0)
        if c:
            assert math.isclose(got[k][0], s, rel_tol=RTOL)


@pytest.mark.parametrize("mode", ["partial", "final"])
def test_pipeline_leaves_partial_and_final_to_the_executor(mode):
    ts = Session(device="cpu")
    ts.register_table("t", TABLE)
    tplan = Lowering(ts.sources).lower(ts.optimizer.optimize(
        ts.planner.create_logical_plan(parse_sql(_sql(0)))))
    tagg = _find_agg(tplan, pp)
    node = pp.PHashAggregate(tagg.input, list(tagg.group_exprs),
                             list(tagg.agg_exprs), mode=mode)
    assert ts.executor.pipeline.try_execute(node) is None
