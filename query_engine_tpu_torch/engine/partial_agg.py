"""Partial/final decomposition of grouped aggregates.

One decomposition, two consumers:
- parallel/dplanner.py: `DECOMPOSABLE` decides whether an aggregate stage
  splits into a per-partition partial and a shuffled final combine (the
  reference's two-stage aggregate split,
  crates/query-distributed/src/planner.rs:200-226);
- engine/chunked.py: partial per row-CHUNK on one card -> concat -> final
  combine (device-memory-bounded execution of 100M+-row aggregates).

All plan surgery is positional: Schema tolerates duplicate names and the
compiled tracer never resolves columns by name.
"""

from __future__ import annotations

from typing import List

from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp

# aggregates with a partial/combine decomposition; AVG splits into
# (SUM, COUNT) partials recombined as sum/NULLIF(count,0)
DECOMPOSABLE = {
    lp.AggFunc.COUNT, lp.AggFunc.SUM, lp.AggFunc.MIN, lp.AggFunc.MAX,
    lp.AggFunc.AVG,
}

_COMBINE = {
    lp.AggFunc.COUNT: lp.AggFunc.SUM,
    lp.AggFunc.SUM: lp.AggFunc.SUM,
    lp.AggFunc.MIN: lp.AggFunc.MIN,
    lp.AggFunc.MAX: lp.AggFunc.MAX,
}


def partial_eligible(plan: pp.PHashAggregate) -> bool:
    """DISTINCT and decimal aggregates are not decomposable — they need
    co-located raw rows (row-exchange on the mesh; no chunking)."""
    for a in plan.agg_exprs:
        if a.distinct:
            return False
        if a.expr is None:
            continue
        if a.func not in DECOMPOSABLE:
            return False
        if a.expr.dtype.kind.name == "DECIMAL128":
            return False
    return True


def build_partial_final(plan: pp.PHashAggregate):
    """-> (partial aggregate over plan.input, final aggregate over the
    partial, output projection over the final). Cached on the plan node."""
    from query_engine_tpu_torch.core.types import DataType

    cached = getattr(plan, "_qe_partial_final", None)
    if cached is not None:
        return cached
    k = len(plan.group_exprs)
    partial_aggs: List[lp.AggregateExpr] = []
    slots: List[List[int]] = []  # per original agg: partial column offsets
    for a in plan.agg_exprs:
        if a.func is lp.AggFunc.AVG:
            slots.append([len(partial_aggs), len(partial_aggs) + 1])
            partial_aggs.append(lp.AggregateExpr(lp.AggFunc.SUM, a.expr))
            partial_aggs.append(lp.AggregateExpr(lp.AggFunc.COUNT, a.expr))
        else:
            slots.append([len(partial_aggs)])
            partial_aggs.append(lp.AggregateExpr(a.func, a.expr))
    partial = pp.PHashAggregate(
        input=plan.input, group_exprs=list(plan.group_exprs),
        agg_exprs=partial_aggs, mode="single",
    )
    pschema = partial.schema()

    def colref(i):
        f = pschema.field(i)
        return lp.ColumnRef(i, f.name, f.data_type, f.nullable)

    final_aggs = [
        lp.AggregateExpr(_COMBINE[pa.func], colref(k + j))
        for j, pa in enumerate(partial_aggs)
    ]
    final = pp.PHashAggregate(
        input=partial, group_exprs=[colref(i) for i in range(k)],
        agg_exprs=final_aggs, mode="single",
    )
    fschema = final.schema()

    def fref(i):
        f = fschema.field(i)
        return lp.ColumnRef(i, f.name, f.data_type, f.nullable)

    out_schema = plan.schema()
    proj_exprs: List[lp.LogicalExpr] = []
    for i in range(k):
        proj_exprs.append(lp.AliasExpr(fref(i), out_schema.field(i).name))
    f64 = DataType.float64()
    for a, sl, f in zip(plan.agg_exprs, slots, out_schema.fields[k:]):
        if a.func is lp.AggFunc.AVG:
            # NULLIF(count, 0): all-null groups stay NULL, matching the
            # single-pass AVG's validity (has = count > 0)
            div = lp.BinaryExpr(
                lp.CastExpr(fref(k + sl[0]), f64), lp.BinOp.DIV,
                lp.CastExpr(
                    lp.ScalarFnExpr(
                        lp.ScalarFn.NULLIF,
                        [fref(k + sl[1]),
                         lp.Literal(lp.ScalarValue.int64(0))],
                    ),
                    f64,
                ),
            )
            proj_exprs.append(lp.AliasExpr(div, f.name))
        else:
            proj_exprs.append(lp.AliasExpr(fref(k + sl[0]), f.name))
    proj = pp.PProjection(input=final, exprs=proj_exprs)
    out = (partial, final, proj)
    plan._qe_partial_final = out
    return out
