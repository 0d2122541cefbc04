"""Logical -> physical plan lowering.

The reference duplicates this lowering three times (pgwire backend.rs:614-724,
extended.rs:419-560, cli/commands.rs:275-397); SURVEY.md §7 "What NOT to
rebuild" calls for exactly one module — this is it.

Join lowering extracts equi-key pairs from the ON predicate (an AND-tree of
equality comparisons between one-side column expressions); anything else
becomes a residual predicate applied after the join (INNER only — the
reference ignores ON entirely, executor.rs:363-435, which we do not copy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from query_engine_tpu_torch.core.errors import PlanError
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp


class Lowering:
    """Lower LogicalPlan trees given a table-name -> DataSource registry.

    `shared_cte_ids` holds id()s of LogicalPlan nodes referenced from more
    than one SubqueryScan (the planner shares ONE plan object across every
    use of a WITH query). Those lower to ONE shared physical subtree marked
    `shared=True`, which the executor materializes exactly once per query
    (PG WITH semantics) — recomputing a float aggregate along two different
    paths (e.g. a mesh partial/final SUM vs an eager SUM) differs in
    last-ulp rounding and breaks equality predicates like TPC-H Q15's
    `total_revenue = (SELECT MAX(total_revenue) FROM revenue)`."""

    def __init__(self, sources: Dict[str, object],
                 shared_cte_ids: Optional[set] = None):
        self.sources = {k.lower(): v for k, v in sources.items()}
        self.shared_cte_ids = shared_cte_ids or set()
        self._cte_memo: Dict[int, pp.PhysicalPlan] = {}

    def lower(self, plan: lp.LogicalPlan) -> pp.PhysicalPlan:
        if isinstance(plan, lp.TableScan):
            src = self.sources.get(plan.table_name.lower())
            if src is None:
                raise PlanError(f"no data source for table '{plan.table_name}'")
            return pp.PScan(plan.table_name, src, plan.schema(), plan.projection)
        if isinstance(plan, lp.Projection):
            return pp.PProjection(self.lower(plan.input), [
                self._lower_expr(e) for e in plan.exprs
            ])
        if isinstance(plan, lp.Filter):
            accelerated = self._try_index_scan(plan)
            if accelerated is not None:
                return accelerated
            return pp.PFilter(
                self.lower(plan.input), self._lower_expr(plan.predicate)
            )
        if isinstance(plan, lp.Join):
            return self._lower_join(plan)
        if isinstance(plan, lp.Aggregate):
            return self._lower_aggregate(plan)
        if isinstance(plan, lp.Sort):
            return pp.PSort(
                self.lower(plan.input),
                [
                    lp.SortKey(self._lower_expr(k.expr), k.asc, k.nulls_first)
                    for k in plan.keys
                ],
            )
        if isinstance(plan, lp.Limit):
            return pp.PLimit(self.lower(plan.input), plan.skip, plan.fetch)
        if isinstance(plan, lp.Window):
            return pp.PWindow(
                self.lower(plan.input),
                [self._lower_expr(e) for e in plan.window_exprs],
                plan.names,
            )
        if isinstance(plan, lp.Distinct):
            on = (
                [self._lower_expr(e) for e in plan.on]
                if plan.on is not None
                else None
            )
            return pp.PDistinct(self.lower(plan.input), on)
        if isinstance(plan, lp.SetOp):
            return pp.PSetOp(
                self.lower(plan.left), self.lower(plan.right), plan.kind
            )
        if isinstance(plan, lp.SubqueryScan):
            key = id(plan.input)
            if key in self.shared_cte_ids:
                child = self._cte_memo.get(key)
                if child is None:
                    child = self.lower(plan.input)
                    self._cte_memo[key] = child
                return pp.PSubquery(child, plan.schema(), plan.alias, True)
            return pp.PSubquery(self.lower(plan.input), plan.schema(), plan.alias)
        if isinstance(plan, lp.EmptyRelation):
            return pp.PEmpty(plan.schema(), plan.produce_one_row)
        if isinstance(plan, lp.Values):
            return pp.PValues(
                [[self._lower_expr(e) for e in row] for row in plan.rows],
                plan.schema(),
            )
        if isinstance(plan, lp.Unnest):
            return pp.PUnnest(
                self.lower(plan.input), self._lower_expr(plan.list_expr),
                plan.schema(),
            )
        if isinstance(plan, lp.GenerateSeries):
            return pp.PGenerateSeries(
                plan.start, plan.stop, plan.step, plan.schema(), plan.values
            )
        if isinstance(plan, lp.IndexScan):
            raise PlanError("IndexScan lowering requires Session index manager")
        raise PlanError(f"cannot lower plan node {type(plan).__name__}")

    # ---- index acceleration --------------------------------------------
    def _try_index_scan(self, plan: lp.Filter) -> Optional[pp.PhysicalPlan]:
        """Filter(TableScan) -> PIndexScan when a matching index exists.

        The reference declares this path but falls back to a full scan
        (executor.rs:81-88 TODO); here it is real: equality predicates use
        hash/btree lookup, single-column ranges use btree range_scan, and
        non-index conjuncts become a residual filter.
        """
        scan = plan.input
        if not isinstance(scan, lp.TableScan):
            return None
        source = self.sources.get(scan.table_name.lower())
        indexes = getattr(source, "indexes", None)
        if indexes is None or not indexes.list_indexes():
            return None

        conjuncts = self._split_and(self._lower_expr(plan.predicate))
        schema = scan.schema()

        def col_of(e) -> Optional[str]:
            if isinstance(e, lp.ColumnRef):
                return schema.field(e.index).name.rsplit(".", 1)[-1]
            return None

        def lit_of(e):
            if isinstance(e, lp.Literal) and not e.value.is_null:
                return e.value.value
            return None

        eq: dict = {}
        ranges: dict = {}
        residual: List[lp.LogicalExpr] = []
        used = set()
        for c in conjuncts:
            handled = False
            if isinstance(c, lp.BinaryExpr) and c.op in (
                lp.BinOp.EQ, lp.BinOp.LT, lp.BinOp.LTE, lp.BinOp.GT, lp.BinOp.GTE
            ):
                col, lit, op = col_of(c.left), lit_of(c.right), c.op
                if col is None or lit is None:
                    col, lit = col_of(c.right), lit_of(c.left)
                    flip = {lp.BinOp.LT: lp.BinOp.GT, lp.BinOp.GT: lp.BinOp.LT,
                            lp.BinOp.LTE: lp.BinOp.GTE, lp.BinOp.GTE: lp.BinOp.LTE}
                    op = flip.get(op, op)
                if col is not None and lit is not None:
                    if op is lp.BinOp.EQ and col not in eq:
                        eq[col] = (lit, c)
                        handled = True
                    elif op is not lp.BinOp.EQ:
                        lo, hi, il, ih, cs = ranges.get(
                            col, (None, None, True, True, [])
                        )
                        if op is lp.BinOp.GT:
                            lo, il = lit, False
                        elif op is lp.BinOp.GTE:
                            lo, il = lit, True
                        elif op is lp.BinOp.LT:
                            hi, ih = lit, False
                        else:
                            hi, ih = lit, True
                        cs = cs + [c]
                        ranges[col] = (lo, hi, il, ih, cs)
                        handled = True
            if not handled:
                residual.append(c)

        # equality lookup on a single-column index
        for col, (lit, cexpr) in eq.items():
            idx_name = indexes.find_best_for_columns(
                scan.table_name.lower(), [col]
            )
            if idx_name is None:
                continue
            meta = indexes.metadata(idx_name)
            if meta.columns != [col]:
                continue
            others = [c for c in conjuncts if c is not cexpr]
            res = self._conjoin(others)

            def lookup(source=source, idx_name=idx_name, lit=lit):
                return source.index_lookup(idx_name, (lit,))

            return pp.PIndexScan(
                scan.table_name, source, scan.schema(), idx_name,
                lookup=lookup, residual=res, projection=scan.projection,
            )

        # range scan on a single-column btree index
        for col, (lo, hi, il, ih, cs) in ranges.items():
            idx_name = indexes.find_best_for_columns(
                scan.table_name.lower(), [col]
            )
            if idx_name is None:
                continue
            meta = indexes.metadata(idx_name)
            if meta.columns != [col] or meta.index_type != "btree":
                continue
            others = [c for c in conjuncts if c not in cs]
            res = self._conjoin(others)

            def lookup(source=source, idx_name=idx_name, lo=lo, hi=hi,
                       il=il, ih=ih):
                return source.index_range_scan(
                    idx_name,
                    (lo,) if lo is not None else None,
                    (hi,) if hi is not None else None,
                    il, ih,
                )

            return pp.PIndexScan(
                scan.table_name, source, scan.schema(), idx_name,
                lookup=lookup, residual=res, projection=scan.projection,
            )
        return None

    @staticmethod
    def _conjoin(parts: List[lp.LogicalExpr]) -> Optional[lp.LogicalExpr]:
        out = None
        for p in parts:
            out = p if out is None else lp.BinaryExpr(out, lp.BinOp.AND, p)
        return out

    # ---- joins ---------------------------------------------------------
    def _lower_aggregate(self, plan: lp.Aggregate) -> pp.PhysicalPlan:
        groups = [self._lower_expr(e) for e in plan.group_exprs]
        aggs = [self._lower_expr(e) for e in plan.agg_exprs]
        return build_hash_aggregate(self.lower(plan.input), groups, aggs)

    def _lower_join(self, plan: lp.Join) -> pp.PhysicalPlan:
        left = self.lower(plan.left)
        right = self.lower(plan.right)
        n_left = len(plan.left.schema())
        key_pairs: List[Tuple[lp.LogicalExpr, lp.LogicalExpr]] = []
        residual: Optional[lp.LogicalExpr] = None
        if plan.on is not None:
            conjuncts = self._split_and(self._lower_expr(plan.on))
            res: List[lp.LogicalExpr] = []
            for c in conjuncts:
                pair = self._as_equi_pair(c, n_left)
                if pair is not None:
                    key_pairs.append(pair)
                else:
                    res.append(c)
            for r in res:
                residual = (
                    r if residual is None
                    else lp.BinaryExpr(residual, lp.BinOp.AND, r)
                )
        if plan.join_type is not lp.JoinType.CROSS and not key_pairs:
            if plan.on is None:
                raise PlanError("non-cross join requires an ON condition")
            if plan.join_type is not lp.JoinType.INNER:
                raise PlanError(
                    "outer join requires at least one equi-key in ON"
                )
        # outer joins with non-equi residual ON conditions execute through
        # the eager recompute-unmatched path (executor.
        # _exec_outer_join_residual); inner joins filter post-join
        return pp.PHashJoin(
            left, right, plan.join_type, key_pairs, residual, plan.schema()
        )

    @staticmethod
    def _split_and(e: lp.LogicalExpr) -> List[lp.LogicalExpr]:
        if isinstance(e, lp.BinaryExpr) and e.op is lp.BinOp.AND:
            return Lowering._split_and(e.left) + Lowering._split_and(e.right)
        return [e]

    @staticmethod
    def _side_of(e: lp.LogicalExpr, n_left: int) -> Optional[str]:
        """'l' if e references only left columns, 'r' only right, None mixed."""
        sides = set()

        def visit(x):
            if isinstance(x, lp.ColumnRef):
                sides.add("l" if x.index < n_left else "r")

        lp.walk_exprs(e, visit)
        if sides == {"l"}:
            return "l"
        if sides == {"r"}:
            return "r"
        return None

    @classmethod
    def _as_equi_pair(
        cls, e: lp.LogicalExpr, n_left: int
    ) -> Optional[Tuple[lp.LogicalExpr, lp.LogicalExpr]]:
        if not (isinstance(e, lp.BinaryExpr) and e.op is lp.BinOp.EQ):
            return None
        ls, rs = cls._side_of(e.left, n_left), cls._side_of(e.right, n_left)
        if ls == "l" and rs == "r":
            lexpr, rexpr = e.left, e.right
        elif ls == "r" and rs == "l":
            lexpr, rexpr = e.right, e.left
        else:
            return None
        return lexpr, cls._rebase(rexpr, n_left)

    @classmethod
    def _rebase(cls, e: lp.LogicalExpr, n_left: int) -> lp.LogicalExpr:
        """Shift merged-schema column indices into right-input coordinates."""
        import copy

        e = copy.deepcopy(e)
        seen = set()  # shared subexprs mutate once

        def fix(x):
            if isinstance(x, lp.ColumnRef) and id(x) not in seen:
                seen.add(id(x))
                x.index -= n_left

        lp.walk_exprs(e, fix)
        return e

    # ---- expressions ---------------------------------------------------
    def _lower_expr(self, e: lp.LogicalExpr) -> lp.LogicalExpr:
        """Rewrite subquery expressions to carry physical subplans."""
        if isinstance(e, lp.ScalarSubqueryExpr):
            e2 = lp.ScalarSubqueryExpr.__new__(lp.ScalarSubqueryExpr)
            e2.plan = self.lower(e.plan)
            e2.dtype = e.dtype
            e2.nullable = e.nullable
            return e2
        if isinstance(e, lp.InSubqueryExpr):
            e2 = lp.InSubqueryExpr.__new__(lp.InSubqueryExpr)
            e2.expr = self._lower_expr(e.expr)
            e2.plan = self.lower(e.plan)
            e2.negated = e.negated
            e2.dtype = e.dtype
            e2.nullable = e.nullable
            return e2
        if isinstance(e, lp.ExistsExpr):
            e2 = lp.ExistsExpr.__new__(lp.ExistsExpr)
            e2.plan = self.lower(e.plan)
            e2.negated = e.negated
            e2.dtype = e.dtype
            e2.nullable = e.nullable
            return e2
        if isinstance(e, lp.QuantifiedCmpExpr):
            e2 = lp.QuantifiedCmpExpr.__new__(lp.QuantifiedCmpExpr)
            e2.expr = self._lower_expr(e.expr)
            e2.op = e.op
            e2.is_any = e.is_any
            e2.plan = self.lower(e.plan)
            e2.dtype = e.dtype
            e2.nullable = e.nullable
            return e2
        if isinstance(e, lp.CorrelatedLookupExpr):
            e2 = lp.CorrelatedLookupExpr.__new__(lp.CorrelatedLookupExpr)
            e2.outer_keys = [self._lower_expr(k) for k in e.outer_keys]
            e2.plan = self.lower(e.plan)
            e2.mode = e.mode
            e2.negated = e.negated
            e2.miss_value = e.miss_value
            e2.dtype = e.dtype
            e2.nullable = e.nullable
            return e2
        if isinstance(e, lp.BinaryExpr):
            return lp.BinaryExpr(
                self._lower_expr(e.left), e.op, self._lower_expr(e.right)
            )
        if isinstance(e, lp.UnaryExpr):
            return lp.UnaryExpr(e.op, self._lower_expr(e.expr))
        if isinstance(e, lp.CastExpr):
            return lp.CastExpr(self._lower_expr(e.expr), e.target)
        if isinstance(e, lp.AliasExpr):
            return lp.AliasExpr(self._lower_expr(e.expr), e.alias)
        if isinstance(e, lp.AggregateExpr):
            inner = self._lower_expr(e.expr) if e.expr is not None else None
            inner2 = self._lower_expr(e.expr2) if e.expr2 is not None else None
            ob = tuple(
                (self._lower_expr(k), asc, nf) for k, asc, nf in e.order_by
            )
            flt = self._lower_expr(e.filter) if e.filter is not None else None
            return lp.AggregateExpr(e.func, inner, e.distinct, e.param,
                                    inner2, ob, flt)
        if isinstance(e, lp.ScalarFnExpr):
            return lp.ScalarFnExpr(e.func, [self._lower_expr(a) for a in e.args])
        if isinstance(e, lp.UdfExpr):
            return lp.UdfExpr(
                e.fn_name, [self._lower_expr(a) for a in e.args],
                dtype=e.dtype, nullable=e.nullable,
            )
        if isinstance(e, lp.WindowExpr):
            return lp.WindowExpr(
                e.func,
                [self._lower_expr(a) for a in e.args],
                [self._lower_expr(p) for p in e.partition_by],
                [
                    lp.SortKey(self._lower_expr(k.expr), k.asc, k.nulls_first)
                    for k in e.order_by
                ],
                e.frame,
            )
        if isinstance(e, lp.CaseExpr):
            return lp.CaseExpr(
                [
                    (self._lower_expr(c), self._lower_expr(v))
                    for c, v in e.branches
                ],
                self._lower_expr(e.else_expr) if e.else_expr is not None else None,
            )
        if isinstance(e, lp.InListExpr):
            return lp.InListExpr(
                self._lower_expr(e.expr),
                [self._lower_expr(i) for i in e.items],
                e.negated,
            )
        if isinstance(e, lp.IsNullExpr):
            return lp.IsNullExpr(self._lower_expr(e.expr), e.negated)
        return e


def build_hash_aggregate(input_phys: pp.PhysicalPlan,
                         groups: List[lp.LogicalExpr],
                         aggs: List[lp.AggregateExpr]) -> pp.PhysicalPlan:
    """Physical hash aggregate over already-lowered expressions.

    VARIANCE/STDDEV lower into base aggregates (SUM(x), SUM(x*x), COUNT(x))
    plus a formula projection, so every execution path — eager, compiled
    pipelines, mesh partial/final, chunked, the host distributed executor —
    runs only SUM/COUNT and the statistical family distributes/chunks for
    free. var_pop = M2/c, var_samp = M2/(c-1) with M2 = max(ss - s^2/c, 0)
    (clamped: float cancellation can drive M2 epsilon-negative).

    The two-argument family (COVAR_*/CORR/REGR_*) decomposes the same way
    over PAIR-masked inputs — rows where either argument is NULL are
    excluded entirely (PG semantics) — into the components each function
    needs among sx, sy, sxx, syy, sxy, c (see _COVAR_COMPONENTS)."""
    if not any(a.func in lp.VARIANCE_FNS or a.func in lp.COVAR_FNS
               or a.func in lp.BOOL_FNS for a in aggs):
        return pp.PHashAggregate(input_phys, list(groups), list(aggs))
    from query_engine_tpu_torch.core.types import DataType

    f64 = DataType.float64()
    base_aggs: List[lp.AggregateExpr] = []
    # per input agg: (base index, func or None, component->offset map)
    slots: List[Tuple[int, Optional[lp.AggFunc], Optional[dict]]] = []
    for a in aggs:
        if a.func in lp.VARIANCE_FNS:
            x = lp.CastExpr(a.expr, f64)
            slots.append((len(base_aggs), a.func, None))
            base_aggs.append(lp.AggregateExpr(lp.AggFunc.SUM, x))
            base_aggs.append(lp.AggregateExpr(
                lp.AggFunc.SUM, lp.BinaryExpr(x, lp.BinOp.MUL, x)
            ))
            base_aggs.append(lp.AggregateExpr(lp.AggFunc.COUNT, a.expr))
        elif a.func in lp.BOOL_FNS:
            # BOOL_AND = MIN(m) = 1, BOOL_OR = MAX(m) = 1 over
            # m = CASE WHEN x THEN 1 WHEN NOT x THEN 0 END (NULL stays NULL,
            # so all-NULL groups yield NULL like PG)
            one = lp.Literal(lp.ScalarValue.int64(1))
            zero = lp.Literal(lp.ScalarValue.int64(0))
            m = lp.CaseExpr(
                [(a.expr, one), (lp.UnaryExpr(lp.UnOp.NOT, a.expr), zero)],
                None,
            )
            base_fn = (lp.AggFunc.MIN if a.func is lp.AggFunc.BOOL_AND
                       else lp.AggFunc.MAX)
            slots.append((len(base_aggs), a.func, None))
            base_aggs.append(lp.AggregateExpr(base_fn, m))
        elif a.func in lp.COVAR_FNS:
            pair = lp.BinaryExpr(
                lp.IsNullExpr(a.expr, True), lp.BinOp.AND,
                lp.IsNullExpr(a.expr2, True),
            )
            ym = lp.CaseExpr([(pair, lp.CastExpr(a.expr, f64))], None)
            xm = lp.CaseExpr([(pair, lp.CastExpr(a.expr2, f64))], None)
            comp_exprs = {
                "sx": lambda: lp.AggregateExpr(lp.AggFunc.SUM, xm),
                "sy": lambda: lp.AggregateExpr(lp.AggFunc.SUM, ym),
                "sxx": lambda: lp.AggregateExpr(
                    lp.AggFunc.SUM, lp.BinaryExpr(xm, lp.BinOp.MUL, xm)),
                "syy": lambda: lp.AggregateExpr(
                    lp.AggFunc.SUM, lp.BinaryExpr(ym, lp.BinOp.MUL, ym)),
                "sxy": lambda: lp.AggregateExpr(
                    lp.AggFunc.SUM, lp.BinaryExpr(xm, lp.BinOp.MUL, ym)),
                "c": lambda: lp.AggregateExpr(lp.AggFunc.COUNT, xm),
            }
            comps = {}
            start = len(base_aggs)
            for name in _COVAR_COMPONENTS[a.func]:
                comps[name] = len(base_aggs) - start
                base_aggs.append(comp_exprs[name]())
            slots.append((start, a.func, comps))
        else:
            slots.append((len(base_aggs), None, None))
            base_aggs.append(a)
    base = pp.PHashAggregate(input_phys, list(groups), base_aggs)
    bschema = base.schema()
    k = len(groups)

    def ref(i):
        f = bschema.field(i)
        return lp.ColumnRef(i, f.name, f.data_type, f.nullable)

    def lit_f(v):
        return lp.Literal(lp.ScalarValue.float64(v))

    def lit_i(v):
        return lp.Literal(lp.ScalarValue.int64(v))

    proj_exprs: List[lp.LogicalExpr] = []
    for i in range(k):
        proj_exprs.append(lp.AliasExpr(ref(i), bschema.field(i).name))
    for (j, vfn, comps), a in zip(slots, aggs):
        if vfn is None:
            proj_exprs.append(lp.AliasExpr(ref(k + j), a.name()))
            continue
        if comps is not None:
            proj_exprs.append(lp.AliasExpr(
                _covar_formula(vfn, {n: ref(k + j + o)
                                     for n, o in comps.items()}, f64),
                a.name(),
            ))
            continue
        if vfn in lp.BOOL_FNS:
            proj_exprs.append(lp.AliasExpr(
                lp.BinaryExpr(ref(k + j), lp.BinOp.EQ, lit_i(1)),
                a.name(),
            ))
            continue
        s, ss, c = ref(k + j), ref(k + j + 1), ref(k + j + 2)
        m2 = lp.BinaryExpr(
            ss, lp.BinOp.SUB,
            lp.BinaryExpr(
                lp.BinaryExpr(s, lp.BinOp.MUL, s), lp.BinOp.DIV,
                lp.CastExpr(c, f64),
            ),
        )
        m2 = lp.CaseExpr(
            [(lp.BinaryExpr(m2, lp.BinOp.LT, lit_f(0.0)), lit_f(0.0))],
            m2,
        )
        if vfn in (lp.AggFunc.VAR_POP, lp.AggFunc.STDDEV_POP):
            denom = c  # NULL when c = 0 (s/ss are NULL anyway)
        else:
            denom = lp.ScalarFnExpr(
                lp.ScalarFn.NULLIF,
                [lp.BinaryExpr(c, lp.BinOp.SUB, lit_i(1)), lit_i(0)],
            )  # sample variance needs c >= 2
        var = lp.BinaryExpr(m2, lp.BinOp.DIV, lp.CastExpr(denom, f64))
        if vfn in (lp.AggFunc.STDDEV_POP, lp.AggFunc.STDDEV_SAMP):
            var = lp.ScalarFnExpr(lp.ScalarFn.SQRT, [var])
        proj_exprs.append(lp.AliasExpr(var, a.name()))
    return pp.PProjection(input=base, exprs=proj_exprs)


# Components each two-argument statistic needs (f(Y, X); Sxx etc. are the
# centered second moments computed from these in _covar_formula)
_COVAR_COMPONENTS = {
    lp.AggFunc.COVAR_POP: ("sx", "sy", "sxy", "c"),
    lp.AggFunc.COVAR_SAMP: ("sx", "sy", "sxy", "c"),
    lp.AggFunc.CORR: ("sx", "sy", "sxx", "syy", "sxy", "c"),
    lp.AggFunc.REGR_SLOPE: ("sx", "sy", "sxx", "sxy", "c"),
    lp.AggFunc.REGR_INTERCEPT: ("sx", "sy", "sxx", "sxy", "c"),
    lp.AggFunc.REGR_R2: ("sx", "sy", "sxx", "syy", "sxy", "c"),
    lp.AggFunc.REGR_AVGX: ("sx", "c"),
    lp.AggFunc.REGR_AVGY: ("sy", "c"),
    lp.AggFunc.REGR_COUNT: ("c",),
    lp.AggFunc.REGR_SXX: ("sx", "sxx", "c"),
    lp.AggFunc.REGR_SYY: ("sy", "syy", "c"),
    lp.AggFunc.REGR_SXY: ("sx", "sy", "sxy", "c"),
}


def _covar_formula(fn: lp.AggFunc, r: Dict[str, lp.LogicalExpr], f64):
    """PG formulas over the pair-masked sums. With c = 0 every sum ref is
    NULL, so NULL propagates through the arithmetic without special cases
    (REGR_COUNT returns the count itself: 0, non-null). Sxx/Syy clamp at 0
    against float cancellation; divisors use NULLIF so degenerate inputs
    (c < 2 for COVAR_SAMP, zero X variance for slopes) yield NULL, matching
    PostgreSQL."""
    F = lp.AggFunc

    def lit_f(v):
        return lp.Literal(lp.ScalarValue.float64(v))

    def sub(x, y):
        return lp.BinaryExpr(x, lp.BinOp.SUB, y)

    def mul(x, y):
        return lp.BinaryExpr(x, lp.BinOp.MUL, y)

    def div(x, y):
        return lp.BinaryExpr(x, lp.BinOp.DIV, y)

    def nullif0(x):
        return lp.ScalarFnExpr(lp.ScalarFn.NULLIF, [x, lit_f(0.0)])

    def clamp0(x):
        return lp.CaseExpr(
            [(lp.BinaryExpr(x, lp.BinOp.LT, lit_f(0.0)), lit_f(0.0))], x
        )

    if fn is F.REGR_COUNT:
        return r["c"]
    cf = lp.CastExpr(r["c"], f64)
    if fn is F.REGR_AVGX:
        return div(r["sx"], cf)
    if fn is F.REGR_AVGY:
        return div(r["sy"], cf)
    if fn is F.REGR_SXX:
        return clamp0(sub(r["sxx"], div(mul(r["sx"], r["sx"]), cf)))
    if fn is F.REGR_SYY:
        return clamp0(sub(r["syy"], div(mul(r["sy"], r["sy"]), cf)))
    sxy_c = sub(r["sxy"], div(mul(r["sx"], r["sy"]), cf))
    if fn is F.REGR_SXY:
        return sxy_c
    if fn is F.COVAR_POP:
        return div(sxy_c, cf)
    if fn is F.COVAR_SAMP:
        c1 = lp.ScalarFnExpr(lp.ScalarFn.NULLIF, [
            lp.BinaryExpr(r["c"], lp.BinOp.SUB,
                          lp.Literal(lp.ScalarValue.int64(1))),
            lp.Literal(lp.ScalarValue.int64(0)),
        ])
        return div(sxy_c, lp.CastExpr(c1, f64))
    sxx_c = clamp0(sub(r["sxx"], div(mul(r["sx"], r["sx"]), cf)))
    if fn is F.REGR_SLOPE:
        return div(sxy_c, nullif0(sxx_c))
    if fn is F.REGR_INTERCEPT:
        slope = div(sxy_c, nullif0(sxx_c))
        return div(sub(r["sy"], mul(slope, r["sx"])), cf)
    syy_c = clamp0(sub(r["syy"], div(mul(r["sy"], r["sy"]), cf)))
    if fn is F.CORR:
        return div(sxy_c, lp.ScalarFnExpr(
            lp.ScalarFn.SQRT, [nullif0(mul(sxx_c, syy_c))]
        ))
    assert fn is F.REGR_R2, fn
    return lp.CaseExpr(
        [
            (lp.BinaryExpr(sxx_c, lp.BinOp.EQ, lit_f(0.0)),
             lp.CastExpr(lp.Literal(lp.ScalarValue.null()), f64)),
            (lp.BinaryExpr(syy_c, lp.BinOp.EQ, lit_f(0.0)), lit_f(1.0)),
        ],
        div(mul(sxy_c, sxy_c), mul(sxx_c, syy_c)),
    )


# ---------------------------------------------------------------------------
# shared-CTE detection
# ---------------------------------------------------------------------------


def _node_exprs(plan: lp.LogicalPlan):
    """Every LogicalExpr a plan node holds directly (for subplan walks)."""
    if isinstance(plan, lp.Projection):
        return list(plan.exprs)
    if isinstance(plan, lp.Filter):
        return [plan.predicate]
    if isinstance(plan, lp.Join):
        return [plan.on] if plan.on is not None else []
    if isinstance(plan, lp.Aggregate):
        return list(plan.group_exprs) + list(plan.agg_exprs)
    if isinstance(plan, lp.Sort):
        return [k.expr for k in plan.keys]
    if isinstance(plan, lp.Window):
        return list(plan.window_exprs)
    if isinstance(plan, lp.Distinct):
        return list(plan.on) if plan.on is not None else []
    if isinstance(plan, lp.Values):
        return [e for row in plan.rows for e in row]
    return []


def shared_subquery_ids(plan: lp.LogicalPlan) -> set:
    """id()s of plan nodes referenced by MORE than one SubqueryScan — i.e.
    WITH queries used multiple times (the planner shares one plan object
    across uses, including uses inside subquery expressions)."""
    counts: Dict[int, int] = {}

    def walk_plan(p: lp.LogicalPlan):
        if isinstance(p, lp.SubqueryScan):
            counts[id(p.input)] = counts.get(id(p.input), 0) + 1
        for e in _node_exprs(p):
            lp.walk_exprs(e, visit_expr)
        for c in p.children():
            walk_plan(c)

    def visit_expr(e: lp.LogicalExpr):
        if isinstance(
            e,
            (lp.ScalarSubqueryExpr, lp.InSubqueryExpr, lp.ExistsExpr,
             lp.QuantifiedCmpExpr, lp.CorrelatedLookupExpr),
        ):
            walk_plan(e.plan)

    walk_plan(plan)
    return {k for k, n in counts.items() if n >= 2}
