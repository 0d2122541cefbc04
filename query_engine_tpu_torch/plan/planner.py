"""Planner: AST -> LogicalPlan.

Parity surface: reference crates/query-planner/src/planner.rs:7-311 —
register_table, create_logical_plan, table-alias resolution by name prefixing
("table.column" field names, prefix_schema_with_table planner.rs:313-327),
CTE planning via schema map (:25-35), JOIN schema merging (:113-166,329-343),
aggregate detection + output schema construction (:180-277), suffix-match
column resolution fallback (:352-404), numeric coercion (:831-848).

Unlike the reference, aggregate outputs are typed accurately (its planner
types every aggregate Float64, planner.rs:239 — a looseness SURVEY.md flags);
we type them the way its *executor* actually computes (operators.rs:745-848),
which is what result parity is measured against.

Unlike the reference, a sum or difference of numeric literals with a
fraction folds exactly, as PostgreSQL's numeric type folds it (`_exact_sum`):
`.06 + 0.01` is 0.07 here and 0.06999999999999999 in the JAX package, so
TPC-H Q6's `l_discount BETWEEN .06 - 0.01 AND .06 + 0.01` keeps the 0.07
discounts here and drops them there. Rows differ wherever such a bound
meets a value; tests/test_torch_comma_joins.py holds both. A bound
parameter stays a DOUBLE (PostgreSQL's float8), so `$1 + 0.01` with $1 =
0.06 folds in floats here too, as the refresh and wire tests of Q6 hold.
"""

from __future__ import annotations

import decimal
from typing import Dict, List, Optional, Sequence

from query_engine_tpu_torch.core.errors import PlanError
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType
from query_engine_tpu_torch.core.udf import UdfRegistry
from query_engine_tpu_torch.sql import ast
from query_engine_tpu_torch.plan import logical as lp


_BINOP_MAP = {
    ast.BinaryOperator.PLUS: lp.BinOp.ADD,
    ast.BinaryOperator.MINUS: lp.BinOp.SUB,
    ast.BinaryOperator.MULTIPLY: lp.BinOp.MUL,
    ast.BinaryOperator.DIVIDE: lp.BinOp.DIV,
    ast.BinaryOperator.MODULO: lp.BinOp.MOD,
    ast.BinaryOperator.EQ: lp.BinOp.EQ,
    ast.BinaryOperator.NEQ: lp.BinOp.NEQ,
    ast.BinaryOperator.LT: lp.BinOp.LT,
    ast.BinaryOperator.LTE: lp.BinOp.LTE,
    ast.BinaryOperator.GT: lp.BinOp.GT,
    ast.BinaryOperator.GTE: lp.BinOp.GTE,
    ast.BinaryOperator.AND: lp.BinOp.AND,
    ast.BinaryOperator.OR: lp.BinOp.OR,
    ast.BinaryOperator.TS_MATCH: lp.BinOp.TS_MATCH,
    ast.BinaryOperator.LIKE: lp.BinOp.LIKE,
    ast.BinaryOperator.ILIKE: lp.BinOp.ILIKE,
    ast.BinaryOperator.NOT_LIKE: lp.BinOp.NOT_LIKE,
    ast.BinaryOperator.NOT_ILIKE: lp.BinOp.NOT_ILIKE,
    ast.BinaryOperator.CONCAT_OP: lp.BinOp.CONCAT,
    ast.BinaryOperator.REGEX_MATCH: lp.BinOp.REGEX_MATCH,
    ast.BinaryOperator.REGEX_IMATCH: lp.BinOp.REGEX_IMATCH,
    ast.BinaryOperator.NOT_REGEX_MATCH: lp.BinOp.NOT_REGEX_MATCH,
    ast.BinaryOperator.NOT_REGEX_IMATCH: lp.BinOp.NOT_REGEX_IMATCH,
    ast.BinaryOperator.SIMILAR_TO: lp.BinOp.SIMILAR_TO,
    ast.BinaryOperator.NOT_SIMILAR_TO: lp.BinOp.NOT_SIMILAR_TO,
    ast.BinaryOperator.JSON_GET: lp.BinOp.JSON_GET,
    ast.BinaryOperator.JSON_GET_TEXT: lp.BinOp.JSON_GET_TEXT,
    ast.BinaryOperator.JSON_PATH: lp.BinOp.JSON_PATH,
    ast.BinaryOperator.JSON_PATH_TEXT: lp.BinOp.JSON_PATH_TEXT,
}


def prefix_schema(schema: Schema, prefix: str) -> Schema:
    """Qualify every bare field name with `prefix.` (planner.rs:313-327)."""
    fields = []
    for f in schema:
        name = f.name if "." in f.name else f"{prefix}.{f.name}"
        fields.append(Field(name, f.data_type, f.nullable))
    return Schema(fields)


def unqualified(name: str) -> str:
    return name.rsplit(".", 1)[-1]


class Resolver:
    """Column resolution over a (possibly prefixed) schema: exact match first,
    then unique suffix match (planner.rs:352-404)."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def resolve(self, name: str) -> lp.ColumnRef:
        idx = self.schema.try_index_of(name)
        if idx is None:
            suffix = "." + name
            matches = [
                i for i, f in enumerate(self.schema.fields)
                if f.name.endswith(suffix) or f.name == name
            ]
            if not matches:
                # bare-name match against unqualified field names
                matches = [
                    i for i, f in enumerate(self.schema.fields)
                    if unqualified(f.name) == name
                ]
            if len(matches) > 1:
                raise PlanError(f"ambiguous column '{name}'")
            if not matches:
                raise PlanError(
                    f"column '{name}' not found in {self.schema.names()}"
                )
            idx = matches[0]
        f = self.schema.field(idx)
        return lp.ColumnRef(idx, f.name, f.data_type, f.nullable)


def _exact_sum(e: "ast.BinaryOp") -> Optional[lp.Literal]:
    """Sums and differences of numeric literals, one of them with a
    fraction (TPC-H Q6's `.06 + 0.01`), folded exactly as PostgreSQL's
    numeric arithmetic folds them, then rounded once to DOUBLE: 0.07, where
    float arithmetic gives 0.06999999999999999. A bound parameter is a
    DOUBLE, as PostgreSQL takes one sent as float8, so a sum with one folds
    in floats. None for anything else."""
    B = ast.BinaryOperator
    texts = []

    def exact(x):
        if isinstance(x, ast.NumberLit):
            if x.bound:
                return None
            texts.append(x.value)
            try:
                return decimal.Decimal(x.value)
            except decimal.InvalidOperation:
                return None
        if isinstance(x, ast.UnaryOp) and x.op is ast.UnaryOperator.MINUS:
            v = exact(x.expr)
            return None if v is None else -v
        if isinstance(x, ast.BinaryOp) and x.op in (B.PLUS, B.MINUS):
            a, b = exact(x.left), exact(x.right)
            if a is None or b is None:
                return None
            return a + b if x.op is B.PLUS else a - b
        return None

    with decimal.localcontext() as ctx:
        ctx.prec = 60
        v = exact(e)
    if v is None or not any("." in t for t in texts) or any(
            c in t for t in texts for c in "eE"):
        return None
    return lp.Literal(lp.ScalarValue.float64(float(v)))


class Planner:
    """AST -> LogicalPlan over a registry of table schemas."""

    def __init__(self, udfs: Optional[UdfRegistry] = None):
        self.tables: Dict[str, Schema] = {}
        # view name -> planned LogicalPlan (bound at CREATE VIEW, like PG);
        # every reference shares the object, so a view used twice in one
        # query rides the shared-CTE single materialization
        self.views: Dict[str, "lp.LogicalPlan"] = {}
        self.udfs = udfs or UdfRegistry()

    def register_table(self, name: str, schema: Schema) -> None:
        self.tables[name.lower()] = schema

    def deregister_table(self, name: str) -> None:
        self.tables.pop(name.lower(), None)

    def register_view(self, name: str, plan: "lp.LogicalPlan") -> None:
        self.views[name.lower()] = plan

    def deregister_view(self, name: str) -> None:
        self.views.pop(name.lower(), None)

    # ---- entry ---------------------------------------------------------
    def create_logical_plan(self, stmt: ast.Statement) -> lp.LogicalPlan:
        if isinstance(stmt, ast.Select):
            return self.plan_select(stmt.select, {})
        if isinstance(stmt, ast.WithSelect):
            return self.plan_with_select(stmt)
        raise PlanError(
            f"statement {type(stmt).__name__} is handled by the session layer"
        )

    def plan_with_select(self, stmt: ast.WithSelect) -> lp.LogicalPlan:
        ctes: Dict[str, lp.LogicalPlan] = {}
        for cte in stmt.ctes:
            if stmt.recursive and self._references_table(cte.query, cte.name):
                raise PlanError(
                    "recursive CTE requires iterative execution; "
                    "use Session which implements fixed-point recursion"
                )
            plan = self.plan_select(cte.query, dict(ctes))
            if cte.columns:
                plan = self._rename_plan(plan, list(cte.columns))
            ctes[cte.name.lower()] = plan
        return self.plan_select(stmt.select, ctes)

    @staticmethod
    def _references_table(sel: ast.SelectStatement, name: str) -> bool:
        refs: List[str] = []

        def visit_tr(tr):
            if isinstance(tr, ast.TableName):
                refs.append(tr.name.lower())
            elif isinstance(tr, ast.SubqueryRef):
                visit_sel(tr.query)

        def visit_sel(s):
            if s.from_ is not None:
                visit_tr(s.from_)
            for j in s.joins:
                visit_tr(j.right)
            if s.union_clause:
                visit_sel(s.union_clause.select)

        visit_sel(sel)
        return name.lower() in refs

    @staticmethod
    def _rename_plan(plan: lp.LogicalPlan, names: List[str]) -> lp.LogicalPlan:
        schema = plan.schema()
        if len(names) != len(schema):
            raise PlanError(
                f"CTE column list has {len(names)} names for {len(schema)} columns"
            )
        exprs = [
            lp.AliasExpr(
                lp.ColumnRef(i, f.name, f.data_type, f.nullable), n
            )
            for i, (f, n) in enumerate(zip(schema, names))
        ]
        return lp.Projection(plan, exprs)

    # ---- SELECT --------------------------------------------------------
    def plan_select(
        self, sel: ast.SelectStatement, ctes: Dict[str, lp.LogicalPlan]
    ) -> lp.LogicalPlan:
        plan = self._plan_from(sel, ctes)
        scope = Resolver(plan.schema())

        if sel.selection is not None:
            pred = self.plan_expr(sel.selection, scope, ctes)
            plan = lp.Filter(plan, pred)
            scope = Resolver(plan.schema())

        # ---- aggregate detection (planner.rs:180-277) ----
        proj_exprs_ast = [
            it.expr for it in sel.projection if isinstance(it, ast.ExprItem)
        ]
        has_agg = bool(sel.group_by) or any(
            self._ast_has_aggregate(e) for e in proj_exprs_ast
        ) or (sel.having is not None and self._ast_has_aggregate(sel.having))

        group_lexprs: List[lp.LogicalExpr] = []
        agg_map: Dict[str, int] = {}
        agg_exprs: List[lp.AggregateExpr] = []
        pre_agg_scope = scope

        if has_agg:
            group_lexprs = [
                self.plan_expr(g, scope, ctes) for g in sel.group_by
            ]

            def collect(e: ast.Expr):
                for a in self._ast_collect_aggregates(e):
                    le = self._plan_aggregate(a, pre_agg_scope, ctes)
                    key = le.name() + ("|d" if le.distinct else "")
                    if key not in agg_map:
                        agg_map[key] = len(agg_exprs)
                        agg_exprs.append(le)

            for e in proj_exprs_ast:
                collect(e)
            if sel.having is not None:
                collect(sel.having)
            for ob in sel.order_by:
                collect(ob.expr)

            if sel.grouping_sets:
                plan = self._plan_grouping_sets(
                    plan, group_lexprs, agg_exprs, sel.grouping_sets
                )
            else:
                plan = lp.Aggregate(plan, group_lexprs, agg_exprs)
            scope = Resolver(plan.schema())

        def plan_post_agg(e: ast.Expr) -> lp.LogicalExpr:
            """Plan an expression over aggregate output: aggregate calls map
            to agg columns, group exprs map to group columns."""
            if has_agg:
                return self._plan_expr_agg(
                    e, scope, pre_agg_scope, group_lexprs, agg_map,
                    len(group_lexprs), agg_exprs, ctes,
                )
            return self.plan_expr(e, scope, ctes)

        if sel.having is not None:
            if not has_agg:
                raise PlanError("HAVING requires GROUP BY or aggregates")
            plan = lp.Filter(plan, plan_post_agg(sel.having))
            scope = Resolver(plan.schema())

        # ---- window functions ----
        win_asts: List[ast.Expr] = []
        for e in proj_exprs_ast:
            self._ast_collect_windows(e, win_asts)
        if win_asts:
            wexprs: List[lp.WindowExpr] = []
            names: List[str] = []
            for i, w in enumerate(win_asts):
                wexprs.append(self._plan_window(w, scope, ctes, plan_post_agg))
                names.append(f"__win{i}")
            plan = lp.Window(plan, wexprs, names)
            scope = Resolver(plan.schema())
            win_map = {
                id(a): lp.ColumnRef(
                    len(plan.input.schema()) + i, names[i],
                    wexprs[i].dtype, wexprs[i].nullable,
                )
                for i, a in enumerate(win_asts)
            }
        else:
            win_map = {}

        # ---- projection ----
        proj: List[lp.LogicalExpr] = []
        input_schema = plan.schema()
        for item in sel.projection:
            if isinstance(item, ast.WildcardItem):
                base = pre_agg_scope.schema if not has_agg else input_schema
                for i, f in enumerate(input_schema if has_agg else base):
                    proj.append(
                        lp.AliasExpr(
                            lp.ColumnRef(i, f.name, f.data_type, f.nullable),
                            unqualified(f.name),
                        )
                    )
            elif isinstance(item, ast.QualifiedWildcard):
                prefix = item.table + "."
                found = False
                for i, f in enumerate(input_schema):
                    if f.name.startswith(prefix):
                        proj.append(
                            lp.AliasExpr(
                                lp.ColumnRef(i, f.name, f.data_type, f.nullable),
                                unqualified(f.name),
                            )
                        )
                        found = True
                if not found:
                    raise PlanError(f"unknown table alias '{item.table}'")
            else:
                e = self._plan_projection_item(
                    item.expr, plan_post_agg, win_map
                )
                name = item.alias or self._output_name(item.expr, e)
                proj.append(lp.AliasExpr(e, name))
        # ---- ORDER BY resolution (before projection is final: keys not
        # visible in the projection become hidden sort columns) ----
        proj_schema = Schema(
            [Field(e.name(), e.dtype, e.nullable) for e in proj]
        )
        proj_scope = Resolver(proj_schema)
        sort_keys: List[lp.SortKey] = []
        extra_exprs: List[lp.LogicalExpr] = []
        for ob in sel.order_by:
            e = ob.expr
            key_expr = None
            if isinstance(e, ast.NumberLit) and "." not in e.value:
                i = int(e.value) - 1
                f = proj_schema.field(i)
                key_expr = lp.ColumnRef(i, f.name, f.data_type, f.nullable)
            else:
                try:
                    key_expr = self.plan_expr(e, proj_scope, ctes)
                except PlanError:
                    hidden = plan_post_agg(e)
                    idx = len(proj) + len(extra_exprs)
                    name = f"__sort{len(extra_exprs)}"
                    extra_exprs.append(lp.AliasExpr(hidden, name))
                    key_expr = lp.ColumnRef(
                        idx, name, hidden.dtype, hidden.nullable
                    )
            sort_keys.append(lp.SortKey(key_expr, ob.asc, ob.nulls_first))

        if extra_exprs and (sel.distinct or sel.distinct_on is not None):
            raise PlanError(
                "for SELECT DISTINCT, ORDER BY expressions must appear in "
                "the select list"
            )

        plan = lp.Projection(plan, proj + extra_exprs)
        proj_scope = Resolver(plan.schema())

        # ---- DISTINCT ----
        if sel.distinct:
            plan = lp.Distinct(plan)
        elif sel.distinct_on is not None:
            keys = [self.plan_expr(e, proj_scope, ctes) for e in sel.distinct_on]
            plan = lp.Distinct(plan, on=keys)

        # ---- ORDER BY ----
        if sort_keys:
            plan = lp.Sort(plan, sort_keys)
        if extra_exprs:
            # strip the hidden sort columns
            plan = lp.Projection(
                plan,
                [
                    lp.ColumnRef(i, e.name(), e.dtype, e.nullable)
                    for i, e in enumerate(proj)
                ],
            )

        # ---- LIMIT/OFFSET ----
        if sel.limit is not None or sel.offset is not None:
            plan = lp.Limit(plan, skip=sel.offset or 0, fetch=sel.limit)

        # ---- set operations ----
        if sel.union_clause is not None:
            right = self.plan_select(sel.union_clause.select, ctes)
            if len(right.schema()) != len(plan.schema()):
                raise PlanError("UNION inputs have different column counts")
            kind = {
                ast.SetOperation.UNION: lp.SetOpKind.UNION,
                ast.SetOperation.UNION_ALL: lp.SetOpKind.UNION_ALL,
                ast.SetOperation.INTERSECT: lp.SetOpKind.INTERSECT,
                ast.SetOperation.EXCEPT: lp.SetOpKind.EXCEPT,
            }[sel.union_clause.set_op]
            plan = lp.SetOp(plan, right, kind)
            if kind is lp.SetOpKind.UNION:
                plan = lp.Distinct(plan)
        return plan

    def _plan_order_expr(self, e, proj_scope, plan_post_agg):
        # ordinals: ORDER BY 1
        if isinstance(e, ast.NumberLit) and "." not in e.value:
            i = int(e.value) - 1
            f = proj_scope.schema.field(i)
            return lp.ColumnRef(i, f.name, f.data_type, f.nullable)
        try:
            return self.plan_expr(e, proj_scope, {})
        except PlanError:
            # Not visible in projection output: resolve against the
            # pre-projection scope; the executor sorts before projecting
            # in that case (physical planning handles the swap).
            return plan_post_agg(e)

    def _plan_projection_item(self, e, plan_post_agg, win_map):
        return self._rewrite_with_windows(e, plan_post_agg, win_map)

    def _rewrite_with_windows(self, e, plan_post_agg, win_map):
        if id(e) in win_map:
            return win_map[id(e)]
        if isinstance(e, ast.BinaryOp):
            # only decompose when a window call is inside; otherwise keep the
            # expression whole so plan_post_agg can structurally match it
            # against GROUP BY expressions (e.g. SELECT age % 3 ... GROUP BY
            # age % 3)
            wins: List[ast.Expr] = []
            self._ast_collect_windows(e, wins)
            if wins:
                left = self._rewrite_with_windows(e.left, plan_post_agg, win_map)
                right = self._rewrite_with_windows(e.right, plan_post_agg, win_map)
                return lp.BinaryExpr(left, _BINOP_MAP[e.op], right)
        return plan_post_agg(e)

    @staticmethod
    def _output_name(e: ast.Expr, planned: lp.LogicalExpr) -> str:
        if isinstance(e, ast.Column):
            return e.name
        if isinstance(e, ast.QualifiedColumn):
            return e.column
        return planned.name()

    # ---- FROM / joins --------------------------------------------------
    def _plan_from(
        self, sel: ast.SelectStatement, ctes: Dict[str, lp.LogicalPlan]
    ) -> lp.LogicalPlan:
        if sel.from_ is None:
            return lp.EmptyRelation(Schema([]), produce_one_row=True)
        if isinstance(sel.from_, ast.UnnestRef):
            # UNNEST over a literal/subquery-free expr with no base table
            plan = self._plan_unnest(
                lp.EmptyRelation(Schema([]), produce_one_row=True),
                sel.from_, ctes,
            )
        else:
            plan = self._plan_table_ref(sel.from_, ctes)
        for join in sel.joins:
            if isinstance(join.right, ast.UnnestRef):
                if join.join_type is not ast.JoinType.CROSS:
                    raise PlanError(
                        "UNNEST joins laterally: use a comma or CROSS JOIN"
                    )
                plan = self._plan_unnest(plan, join.right, ctes)
                continue
            right = self._plan_table_ref(join.right, ctes)
            jt = lp.JoinType[join.join_type.name]
            using = join.using
            if join.natural:
                rnames = {unqualified(f.name) for f in right.schema()}
                seen = set()
                common = []
                for f in plan.schema():
                    n = unqualified(f.name)
                    if n in rnames and n not in seen:
                        seen.add(n)
                        common.append(n)
                if not common:
                    # PG: NATURAL JOIN with no common columns degenerates
                    # to a cross join
                    jt = lp.JoinType.CROSS
                using = tuple(common)
            if using:
                plan = self._plan_using_join(plan, right, jt, using)
                continue
            merged = Resolver(plan.schema().merge(right.schema()))
            on = (
                self.plan_expr(join.on, merged, ctes)
                if join.on is not None
                else None
            )
            plan = lp.Join(plan, right, jt, on)
        return plan

    def _plan_using_join(self, left, right, jt, using) -> lp.LogicalPlan:
        """JOIN ... USING (c1, ...) / NATURAL JOIN: equality on the named
        columns, then a projection that keeps ONE merged output column per
        name (PG semantics: the merged column comes first and is
        unqualified; FULL joins merge via COALESCE so unmatched rows from
        either side keep their key)."""
        lsch, rsch = left.schema(), right.schema()
        lres, rres = Resolver(lsch), Resolver(rsch)
        nleft = len(lsch.fields)
        on = None
        pairs = []
        for c in using:
            lc = lres.resolve(c)
            rc0 = rres.resolve(c)
            rc = lp.ColumnRef(rc0.index + nleft, rc0.col_name,
                              rc0.dtype, rc0.nullable)
            pairs.append((c, lc, rc, rc0.index))
            eq = lp.BinaryExpr(lc, lp.BinOp.EQ, rc)
            on = eq if on is None else lp.BinaryExpr(on, lp.BinOp.AND, eq)
        joined = lp.Join(left, right, jt, on)
        jsch = joined.schema()
        exprs: List[lp.LogicalExpr] = []
        for c, lc, rc, _ri in pairs:
            # the join output may widen nullability (outer sides): re-read
            # the column metadata from the joined schema
            lj = jsch.field(lc.index)
            rj = jsch.field(rc.index)
            ljr = lp.ColumnRef(lc.index, lj.name, lj.data_type, lj.nullable)
            rjr = lp.ColumnRef(rc.index, rj.name, rj.data_type, rj.nullable)
            if jt is lp.JoinType.FULL:
                e: lp.LogicalExpr = lp.ScalarFnExpr(
                    lp.ScalarFn.COALESCE, [ljr, rjr]
                )
            elif jt is lp.JoinType.RIGHT:
                e = rjr
            else:
                e = ljr
            exprs.append(lp.AliasExpr(e, c))
        drop = {lc.index for _c, lc, _rc, _ri in pairs}
        drop |= {rc.index for _c, _lc, rc, _ri in pairs}
        for i, f in enumerate(jsch.fields):
            if i in drop:
                continue
            exprs.append(lp.AliasExpr(
                lp.ColumnRef(i, f.name, f.data_type, f.nullable), f.name
            ))
        return lp.Projection(joined, exprs)

    def _plan_table_ref(
        self, tr: ast.TableReference, ctes: Dict[str, lp.LogicalPlan]
    ) -> lp.LogicalPlan:
        if isinstance(tr, ast.ValuesRef):
            return self._plan_values_ref(tr, ctes)
        if isinstance(tr, ast.TableFnRef):
            return self._plan_table_fn(tr, ctes)
        if isinstance(tr, ast.SubqueryRef):
            sub = self.plan_select(tr.query, ctes)
            fields = sub.schema().fields
            names = [unqualified(f.name) for f in fields]
            if tr.columns:
                if len(tr.columns) != len(fields):
                    raise PlanError(
                        f"derived table '{tr.alias}' has {len(fields)} "
                        f"columns but {len(tr.columns)} names")
                names = list(tr.columns)
            schema = prefix_schema(
                Schema(
                    [Field(n, f.data_type, f.nullable)
                     for n, f in zip(names, fields)]
                ),
                tr.alias,
            )
            return lp.SubqueryScan(sub, tr.alias, schema)
        assert isinstance(tr, ast.TableName)
        key = tr.name.lower()
        prefix = tr.alias or tr.name
        if key in ctes:
            cte_plan = ctes[key]
            schema = prefix_schema(
                Schema(
                    [Field(unqualified(f.name), f.data_type, f.nullable)
                     for f in cte_plan.schema()]
                ),
                prefix,
            )
            return lp.SubqueryScan(cte_plan, prefix, schema)
        if key in self.views:
            vplan = self.views[key]
            schema = prefix_schema(
                Schema(
                    [Field(unqualified(f.name), f.data_type, f.nullable)
                     for f in vplan.schema()]
                ),
                prefix,
            )
            return lp.SubqueryScan(vplan, prefix, schema)
        if key not in self.tables:
            raise PlanError(f"table '{tr.name}' not found")
        schema = prefix_schema(self.tables[key], prefix)
        return lp.TableScan(tr.name, schema)

    def _plan_values_ref(
        self, tr: ast.ValuesRef, ctes: Dict[str, lp.LogicalPlan]
    ) -> lp.LogicalPlan:
        """(VALUES ...) AS alias(cols): a literal inline relation. Column
        types come from the first typed (non-NULL) expression per column;
        int/float mixes coerce to float64 (PG numeric-ladder behavior)."""
        if not tr.rows:
            raise PlanError("VALUES requires at least one row")
        ncol = len(tr.rows[0])
        if any(len(r) != ncol for r in tr.rows):
            raise PlanError("VALUES rows must all have the same arity")
        if tr.columns and len(tr.columns) != ncol:
            raise PlanError(
                f"VALUES has {ncol} columns but alias names {len(tr.columns)}"
            )
        empty = Resolver(Schema([]))
        rows = [[self.plan_expr(e, empty, ctes) for e in r] for r in tr.rows]
        names = tr.columns or tuple(f"column{i+1}" for i in range(ncol))
        fields = []
        for j in range(ncol):
            exprs = [r[j] for r in rows]
            typed = [x.dtype for x in exprs
                     if not (isinstance(x, lp.Literal) and x.value.is_null)]
            if not typed:
                dt = DataType.utf8()  # all-NULL column: PG defaults to text
            else:
                dt = typed[0]
                for t2 in typed[1:]:
                    if t2 == dt:
                        continue
                    if dt.is_numeric and t2.is_numeric:
                        dt = DataType.float64()
                    else:
                        raise PlanError(
                            f"VALUES column {names[j]} mixes types "
                            f"{dt} and {t2}"
                        )
            for i, x in enumerate(exprs):
                if x.dtype != dt:
                    rows[i][j] = lp.CastExpr(x, dt)
            nullable = any(x.nullable for x in exprs)
            fields.append(Field(names[j], dt, nullable))
        schema = prefix_schema(Schema(fields), tr.alias)
        return lp.Values(rows, schema)

    def _plan_table_fn(self, tr: ast.TableFnRef, ctes) -> lp.LogicalPlan:
        """GENERATE_SERIES(start, stop[, step]) — constant arguments over
        int64, or DATE/TIMESTAMP bounds with an INTERVAL step (PG
        semantics: empty when step moves away from stop; step 0 errors;
        month addition clamps to month length: Jan 31 + 1 mon = Feb 28)."""
        if tr.fn != "generate_series":
            raise PlanError(f"unknown table function {tr.fn}")
        if len(tr.args) not in (2, 3):
            raise PlanError("GENERATE_SERIES takes 2 or 3 arguments")
        if len(tr.columns) > 1:
            raise PlanError("GENERATE_SERIES produces one column")
        col = tr.columns[0] if tr.columns else "generate_series"

        def mkschema(dt):
            return prefix_schema(Schema([Field(col, dt, False)]), tr.alias)

        # temporal form: DATE/TIMESTAMP bounds + INTERVAL step
        if (isinstance(tr.args[0], ast.Cast)
                and tr.args[0].data_type.is_temporal):
            return self._plan_temporal_series(tr, mkschema)

        def const_int(a, what):
            e = self.plan_expr(a, Resolver(Schema([])), ctes)
            neg = False
            if isinstance(e, lp.UnaryExpr) and e.op is lp.UnOp.NEG:
                neg, e = True, e.expr
            if not isinstance(e, lp.Literal) or e.value.is_null or \
                    not e.dtype.is_integer:
                raise PlanError(
                    f"GENERATE_SERIES {what} must be an integer constant"
                )
            v = int(e.value.value)
            return -v if neg else v

        start = const_int(tr.args[0], "start")
        stop = const_int(tr.args[1], "stop")
        step = const_int(tr.args[2], "step") if len(tr.args) == 3 else 1
        if step == 0:
            raise PlanError("GENERATE_SERIES step must not be zero")
        return lp.GenerateSeries(start, stop, step, mkschema(DataType.int64()))

    def _plan_temporal_series(self, tr: ast.TableFnRef, mkschema):
        import datetime

        from query_engine_tpu_torch.core.types import TypeKind

        def temporal_const(a, what):
            if not (isinstance(a, ast.Cast) and a.data_type.is_temporal
                    and isinstance(a.expr, ast.StringLit)):
                raise PlanError(
                    f"GENERATE_SERIES {what} must be a DATE/TIMESTAMP "
                    "constant"
                )
            kind = a.data_type.kind
            try:
                if kind is TypeKind.DATE32:
                    d = datetime.date.fromisoformat(a.expr.value)
                    return kind, (d - datetime.date(1970, 1, 1)).days
                dt = datetime.datetime.fromisoformat(a.expr.value)
                us = int(
                    (dt - datetime.datetime(1970, 1, 1)).total_seconds()
                    * 1e6
                )
                return kind, us
            except ValueError:
                raise PlanError(f"malformed temporal literal {a.expr.value!r}")

        k0, start = temporal_const(tr.args[0], "start")
        k1, stop = temporal_const(tr.args[1], "stop")
        if k0 is not k1:
            raise PlanError("GENERATE_SERIES bounds must share a type")
        if len(tr.args) != 3 or not isinstance(tr.args[2], ast.IntervalLit):
            raise PlanError(
                "temporal GENERATE_SERIES requires an INTERVAL step"
            )
        iv = tr.args[2]
        months, days, micros = iv.months, iv.days, iv.micros
        if months == 0 and days == 0 and micros == 0:
            raise PlanError("GENERATE_SERIES step must not be zero")
        is_date = k0 is TypeKind.DATE32
        dt_out = DataType.date32() if is_date else DataType.timestamp()
        if months == 0:
            if is_date:
                if micros:
                    raise PlanError(
                        "sub-day INTERVAL step over a DATE series"
                    )
                step = days
            else:
                step = micros + days * 86_400_000_000
            return lp.GenerateSeries(start, stop, step, mkschema(dt_out))
        # month strides are non-uniform: generate on the host (clamped
        # month addition), carry the values
        epoch_d = datetime.date(1970, 1, 1)
        epoch_ts = datetime.datetime(1970, 1, 1)
        base = (epoch_d + datetime.timedelta(days=start) if is_date
                else epoch_ts + datetime.timedelta(microseconds=start))

        def add_months(d, n):
            y, m = divmod((d.year * 12 + d.month - 1) + n, 12)
            m += 1
            import calendar

            day = min(d.day, calendar.monthrange(y, m)[1])
            return d.replace(year=y, month=m, day=day)

        def encode(d):
            if is_date:
                return (d - epoch_d).days
            return int((d - epoch_ts).total_seconds() * 1e6)

        probe = add_months(base, months) + datetime.timedelta(
            days=days, microseconds=micros
        )
        forward = encode(probe) > start
        vals, i = [], 0
        while len(vals) < (1 << 24):
            cur = add_months(base, months * i) + datetime.timedelta(
                days=days * i, microseconds=micros * i
            )
            v = encode(cur)
            if (v > stop) if forward else (v < stop):
                break
            vals.append(v)
            i += 1
        else:
            raise PlanError("GENERATE_SERIES longer than 2^24 rows")
        return lp.GenerateSeries(start, stop, 0, mkschema(dt_out), vals)

    def _plan_unnest(self, plan: lp.LogicalPlan, tr: ast.UnnestRef,
                     ctes) -> lp.LogicalPlan:
        """FROM ..., UNNEST(expr) AS u(x): implicit lateral — expr is
        planned against the preceding FROM items' schema and each row
        explodes into one output row per list element."""
        scope = Resolver(plan.schema())
        e = self.plan_expr(tr.expr, scope, ctes)
        from query_engine_tpu_torch.core.types import TypeKind

        if e.dtype.kind is not TypeKind.LIST:
            raise PlanError(
                f"UNNEST requires a LIST value, got {e.dtype}"
            )
        inner = e.dtype.params[0] if e.dtype.params else DataType.utf8()
        col = tr.column or "unnest"
        out = Schema(
            list(plan.schema().fields)
            + [Field(f"{tr.alias}.{col}", inner, True)]
        )
        return lp.Unnest(plan, e, out)

    # ---- expressions ---------------------------------------------------
    def plan_expr(
        self,
        e: ast.Expr,
        scope: Resolver,
        ctes: Dict[str, lp.LogicalPlan],
    ) -> lp.LogicalExpr:
        if isinstance(e, ast.Column):
            return scope.resolve(e.name)
        if isinstance(e, ast.QualifiedColumn):
            return scope.resolve(f"{e.table}.{e.column}")
        if isinstance(e, ast.NumberLit):
            text = e.value
            if any(c in text for c in ".eE") and not text.isdigit():
                return lp.Literal(lp.ScalarValue.float64(float(text)))
            return lp.Literal(lp.ScalarValue.int64(int(text)))
        if isinstance(e, ast.StringLit):
            return lp.Literal(lp.ScalarValue.utf8(e.value))
        if isinstance(e, ast.BoolLit):
            return lp.Literal(lp.ScalarValue.boolean(e.value))
        if isinstance(e, ast.NullLit):
            return lp.Literal(lp.ScalarValue.null())
        if isinstance(e, ast.IntervalLit):
            return lp.IntervalLiteral(e.months, e.days, e.micros)
        if isinstance(e, ast.Param):
            raise PlanError(
                f"unbound parameter ${e.index} (bind parameters before planning)"
            )
        if isinstance(e, ast.BinaryOp):
            exact = _exact_sum(e)
            if exact is not None:
                return exact
            left = self.plan_expr(e.left, scope, ctes)
            right = self.plan_expr(e.right, scope, ctes)
            return lp.BinaryExpr(left, _BINOP_MAP[e.op], right)
        if isinstance(e, ast.UnaryOp):
            inner = self.plan_expr(e.expr, scope, ctes)
            op = lp.UnOp.NOT if e.op is ast.UnaryOperator.NOT else lp.UnOp.NEG
            return lp.UnaryExpr(op, inner)
        if isinstance(e, ast.Aggregate):
            return self._plan_aggregate(e, scope, ctes)
        if isinstance(e, ast.Cast):
            return lp.CastExpr(self.plan_expr(e.expr, scope, ctes), e.data_type)
        if isinstance(e, ast.ScalarFunctionCall):
            args = [self.plan_expr(a, scope, ctes) for a in e.args]
            if e.func is ast.ScalarFunction.PI:
                import math as _math

                return lp.Literal(lp.ScalarValue.float64(_math.pi))
            if e.func is ast.ScalarFunction.MOD:
                if len(args) != 2:
                    raise PlanError("MOD takes exactly 2 arguments")
                return lp.BinaryExpr(args[0], lp.BinOp.MOD, args[1])
            return lp.ScalarFnExpr(lp.ScalarFn[e.func.name], args)
        if isinstance(e, ast.UdfCall):
            udf = self.udfs.get(e.name)
            if udf is None:
                raise PlanError(f"unknown function '{e.name}'")
            args = [self.plan_expr(a, scope, ctes) for a in e.args]
            return lp.UdfExpr(
                e.name, args, dtype=udf.signature.return_type
            )
        if isinstance(e, ast.Case):
            return self._plan_case(e, scope, ctes)
        if isinstance(e, ast.InList):
            inner = self.plan_expr(e.expr, scope, ctes)
            items = [self.plan_expr(i, scope, ctes) for i in e.items]
            return lp.InListExpr(inner, items, e.negated)
        if isinstance(e, ast.IsNull):
            return lp.IsNullExpr(self.plan_expr(e.expr, scope, ctes), e.negated)
        if isinstance(e, ast.Between):
            # plan the operand twice: rewrite passes mutate expression trees
            # in place, so conjuncts must not share nodes
            inner_lo = self.plan_expr(e.expr, scope, ctes)
            inner_hi = self.plan_expr(e.expr, scope, ctes)
            low = self.plan_expr(e.low, scope, ctes)
            high = self.plan_expr(e.high, scope, ctes)
            rng = lp.BinaryExpr(
                lp.BinaryExpr(inner_lo, lp.BinOp.GTE, low),
                lp.BinOp.AND,
                lp.BinaryExpr(inner_hi, lp.BinOp.LTE, high),
            )
            return lp.UnaryExpr(lp.UnOp.NOT, rng) if e.negated else rng
        if isinstance(e, ast.ScalarSubquery):
            try:
                return lp.ScalarSubqueryExpr(self.plan_select(e.query, ctes))
            except PlanError:
                # inner-scope resolution failed: SQL scoping falls back to
                # the outer query -> try decorrelation
                return self._plan_correlated_scalar(e.query, scope, ctes)
        if isinstance(e, ast.InSubquery):
            inner = self.plan_expr(e.expr, scope, ctes)
            return lp.InSubqueryExpr(inner, self.plan_select(e.query, ctes), e.negated)
        if isinstance(e, ast.QuantifiedComparison):
            inner = self.plan_expr(e.expr, scope, ctes)
            sub = self.plan_select(e.query, ctes)
            if len(sub.schema()) != 1:
                raise PlanError(
                    "quantified comparison subquery must return one column"
                )
            B = ast.BinaryOperator
            # = ANY is IN; <> ALL is NOT IN (exact rank membership)
            if e.op is B.EQ and e.is_any:
                return lp.InSubqueryExpr(inner, sub, False)
            if e.op is B.NEQ and not e.is_any:
                return lp.InSubqueryExpr(inner, sub, True)
            m = {B.EQ: lp.BinOp.EQ, B.NEQ: lp.BinOp.NEQ,
                 B.LT: lp.BinOp.LT, B.LTE: lp.BinOp.LTE,
                 B.GT: lp.BinOp.GT, B.GTE: lp.BinOp.GTE}
            if e.op not in m:
                raise PlanError(
                    f"operator {e.op.value} cannot be quantified with ANY/ALL"
                )
            return lp.QuantifiedCmpExpr(inner, m[e.op], e.is_any, sub)
        if isinstance(e, ast.Exists):
            try:
                return lp.ExistsExpr(self.plan_select(e.query, ctes), e.negated)
            except PlanError:
                return self._plan_correlated_exists(
                    e.query, scope, ctes, e.negated
                )
        if isinstance(e, ast.WindowFunction):
            raise PlanError("window function not allowed in this context")
        if isinstance(e, ast.Wildcard):
            raise PlanError("* only allowed inside COUNT(*)")
        raise PlanError(f"cannot plan expression {type(e).__name__}")

    def _plan_case(self, e: ast.Case, scope, ctes) -> lp.LogicalExpr:
        branches = []
        for when, then in e.branches:
            cond = self.plan_expr(when, scope, ctes)
            if e.operand is not None:
                operand = self.plan_expr(e.operand, scope, ctes)
                cond = lp.BinaryExpr(operand, lp.BinOp.EQ, cond)
            branches.append((cond, self.plan_expr(then, scope, ctes)))
        else_e = (
            self.plan_expr(e.else_expr, scope, ctes)
            if e.else_expr is not None
            else None
        )
        return lp.CaseExpr(branches, else_e)

    # PG aliases: VARIANCE = VAR_SAMP, STDDEV = STDDEV_SAMP,
    # MEDIAN = PERCENTILE_CONT(0.5)
    _AGG_ALIASES = {"VARIANCE": "VAR_SAMP", "STDDEV": "STDDEV_SAMP",
                    "MEDIAN": "PERCENTILE_CONT", "EVERY": "BOOL_AND"}

    def _plan_aggregate(self, e: ast.Aggregate, scope, ctes) -> lp.AggregateExpr:
        func = lp.AggFunc[self._AGG_ALIASES.get(e.func.name, e.func.name)]
        if isinstance(e.expr, ast.Wildcard):
            if func is not lp.AggFunc.COUNT:
                raise PlanError(f"{func.value}(*) is not valid")
            return lp.AggregateExpr(func, None, e.distinct)
        inner = self.plan_expr(e.expr, scope, ctes)
        if func in lp.ORDERED_SET_FNS or e.func.name == "MEDIAN":
            if e.func.name == "MEDIAN":
                func, param = lp.AggFunc.PERCENTILE_CONT, (0.5, False)
            else:
                param = e.param
            frac, desc = param
            if func is not lp.AggFunc.MODE:
                if not (0.0 <= frac <= 1.0):
                    raise PlanError(
                        f"{func.value} fraction must be in [0, 1], got {frac}"
                    )
                frac = float(frac)
            if e.distinct:
                raise PlanError(f"{func.value}(DISTINCT ...) is not supported")
            if (not inner.dtype.is_numeric
                    or inner.dtype.kind.name == "DECIMAL128"):
                raise PlanError(
                    f"{func.value} requires a non-decimal numeric argument, "
                    f"got {inner.dtype}"
                )
            return lp.AggregateExpr(func, inner, False, (frac, desc))
        if func in lp.VARIANCE_FNS:
            if e.distinct:
                # the (sum, sumsq) decomposition can't dedup on the raw
                # value: x and -x share a square
                raise PlanError(f"{func.value}(DISTINCT ...) is not supported")
            if not inner.dtype.is_numeric:
                raise PlanError(
                    f"{func.value} requires a numeric argument, "
                    f"got {inner.dtype}"
                )
        if func in lp.BOOL_FNS:
            if inner.dtype.kind.name != "BOOLEAN":
                raise PlanError(
                    f"{func.value} requires a boolean argument, "
                    f"got {inner.dtype}"
                )
            # DISTINCT is legal but a no-op for AND/OR
            return lp.AggregateExpr(func, inner, False)
        if func is lp.AggFunc.ARRAY_AGG:
            flt = None
            if e.filter is not None:
                flt = self.plan_expr(e.filter, scope, ctes)
                if flt.dtype.kind.name != "BOOLEAN":
                    raise PlanError(
                        "FILTER (WHERE ...) predicate must be boolean, "
                        f"got {flt.dtype}"
                    )
            return lp.AggregateExpr(
                func, inner, e.distinct,
                order_by=self._plan_agg_order_by(e, scope, ctes), filter=flt,
            )
        if func is lp.AggFunc.STRING_AGG:
            if not inner.dtype.is_dictionary:
                raise PlanError(
                    f"STRING_AGG requires a string argument, got {inner.dtype}"
                )
            d = self.plan_expr(e.expr2, scope, ctes)
            if not (isinstance(d, lp.Literal)
                    and isinstance(d.value.value, str)):
                raise PlanError("STRING_AGG delimiter must be a string literal")
            return lp.AggregateExpr(
                func, inner, e.distinct, (d.value.value, False),
                order_by=self._plan_agg_order_by(e, scope, ctes),
            )
        if func in lp.COVAR_FNS:
            inner2 = self.plan_expr(e.expr2, scope, ctes)
            for arg in (inner, inner2):
                if not arg.dtype.is_numeric:
                    raise PlanError(
                        f"{func.value} requires numeric arguments, "
                        f"got {arg.dtype}"
                    )
            return lp.AggregateExpr(func, inner, False, expr2=inner2)
        return lp.AggregateExpr(func, inner, e.distinct)

    def _plan_agg_order_by(self, e: ast.Aggregate, scope, ctes) -> tuple:
        """In-call ORDER BY keys (ARRAY_AGG/STRING_AGG), resolved to
        (key_expr, asc, nulls_first) with PG null-placement defaults."""
        out = []
        for ob in e.agg_order_by:
            k = self.plan_expr(ob.expr, scope, ctes)
            nf = ob.nulls_first if ob.nulls_first is not None else not ob.asc
            out.append((k, ob.asc, nf))
        return tuple(out)

    def _plan_window(self, e, scope, ctes, plan_post_agg):
        if isinstance(e, ast.GroupingCall):
            return ()  # args are key references, not value expressions
        if isinstance(e, ast.WindowAggregate):
            if e.distinct:
                raise PlanError("DISTINCT is not supported in window aggregates")
            args = [] if e.arg is None else [plan_post_agg(e.arg)]
        else:
            args = [plan_post_agg(a) for a in e.args]
        partition_by = [plan_post_agg(p) for p in e.over.partition_by]
        order_by = [
            lp.SortKey(plan_post_agg(ob.expr), ob.asc, ob.nulls_first)
            for ob in e.over.order_by
        ]
        try:
            wfn = lp.WindowFn[e.func.name]
        except KeyError:
            raise PlanError(
                f"{e.func.name} is not supported as a window function"
            )
        if wfn is lp.WindowFn.NTH_VALUE:
            if len(args) != 2:
                raise PlanError("NTH_VALUE takes exactly 2 arguments")
            if not (isinstance(args[1], lp.Literal)
                    and isinstance(args[1].value.value, int)):
                raise PlanError(
                    "NTH_VALUE position must be an integer literal"
                )
        return lp.WindowExpr(wfn, args, partition_by, order_by, e.over.frame)

    def _plan_grouping_sets(self, base, group_lexprs, agg_exprs, sets):
        """GROUP BY ROLLUP/CUBE/GROUPING SETS: one Aggregate per grouping
        set, each projected onto the full key layout (absent keys become
        typed NULLs), combined with UNION ALL. Branch subtrees are deep
        copies — rewrite passes mutate plans in place, so branches must not
        share nodes."""
        import copy

        branches = []
        for set_idxs in sets:
            b_base = copy.deepcopy(base)
            keys = [copy.deepcopy(group_lexprs[i]) for i in set_idxs]
            aggs = copy.deepcopy(agg_exprs)
            agg = lp.Aggregate(b_base, keys, aggs)
            aschema = agg.schema()
            exprs: List[lp.LogicalExpr] = []
            for gi, g in enumerate(group_lexprs):
                if gi in set_idxs:
                    pos = set_idxs.index(gi)
                    f = aschema.field(pos)
                    exprs.append(lp.AliasExpr(
                        lp.ColumnRef(pos, f.name, f.data_type, True),
                        g.name(),
                    ))
                else:
                    exprs.append(lp.AliasExpr(
                        lp.CastExpr(
                            lp.Literal(lp.ScalarValue.null()), g.dtype
                        ),
                        g.name(),
                    ))
            for ai in range(len(agg_exprs)):
                pos = len(set_idxs) + ai
                f = aschema.field(pos)
                exprs.append(lp.AliasExpr(
                    lp.ColumnRef(pos, f.name, f.data_type, True),
                    agg_exprs[ai].name(),
                ))
            # hidden bitmask: bit i set when key i is aggregated away —
            # GROUPING() reads it to tell rollup NULLs from data NULLs
            mask = sum(
                1 << gi for gi in range(len(group_lexprs))
                if gi not in set_idxs
            )
            exprs.append(lp.AliasExpr(
                lp.Literal(lp.ScalarValue.int64(mask)), "__grouping"
            ))
            branches.append(lp.Projection(agg, exprs))
        plan = branches[0]
        for b in branches[1:]:
            plan = lp.SetOp(plan, b, lp.SetOpKind.UNION_ALL)
        return plan

    # ---- correlated subquery decorrelation ------------------------------
    # The reference errors on every subquery form (operators.rs:34-52); we
    # additionally support the classic correlated patterns by rewriting them
    # into grouped subplans joined back on the correlation keys:
    #   expr CMP (SELECT AGG(x) FROM t2 WHERE t2.k = outer.k [AND p])
    #     ->  lookup into (SELECT t2.k, AGG(x) FROM t2 WHERE p GROUP BY t2.k)
    #   [NOT] EXISTS (SELECT ... FROM t2 WHERE t2.k = outer.k [AND p])
    #     ->  membership in (SELECT t2.k FROM t2 WHERE p GROUP BY t2.k)
    # evaluated as one vectorized rank-match over the whole outer batch.

    @staticmethod
    def _split_conjuncts(e):
        if isinstance(e, ast.BinaryOp) and e.op is ast.BinaryOperator.AND:
            return (Planner._split_conjuncts(e.left)
                    + Planner._split_conjuncts(e.right))
        return [e]

    def _correlation_split(self, sel, outer_scope, ctes):
        """-> (from_plan, inner_scope, inner conjunct ASTs,
        [(inner key AST, outer key LogicalExpr)])."""
        if sel.union_clause is not None or sel.group_by or sel.having:
            raise PlanError("unsupported correlated subquery shape")
        from_plan = self._plan_from(sel, ctes)
        inner_scope = Resolver(from_plan.schema())

        def plans_inner(a) -> bool:
            try:
                self.plan_expr(a, inner_scope, ctes)
                return True
            except PlanError:
                return False

        _CORR_CMPS = {
            ast.BinaryOperator.EQ, ast.BinaryOperator.NEQ,
            ast.BinaryOperator.LT, ast.BinaryOperator.LTE,
            ast.BinaryOperator.GT, ast.BinaryOperator.GTE,
        }
        _FLIP = {
            ast.BinaryOperator.LT: ast.BinaryOperator.GT,
            ast.BinaryOperator.GT: ast.BinaryOperator.LT,
            ast.BinaryOperator.LTE: ast.BinaryOperator.GTE,
            ast.BinaryOperator.GTE: ast.BinaryOperator.LTE,
            ast.BinaryOperator.NEQ: ast.BinaryOperator.NEQ,
            ast.BinaryOperator.EQ: ast.BinaryOperator.EQ,
        }
        inner_conj, pairs, nonequi = [], [], []
        for c in self._split_conjuncts(sel.selection) if sel.selection else []:
            if plans_inner(c):
                inner_conj.append(c)
                continue
            if isinstance(c, ast.BinaryOp) and c.op in _CORR_CMPS:
                if plans_inner(c.left) and not plans_inner(c.right):
                    inner_ast, outer_ast, op = c.left, c.right, c.op
                elif plans_inner(c.right) and not plans_inner(c.left):
                    inner_ast, outer_ast, op = c.right, c.left, _FLIP[c.op]
                else:
                    raise PlanError(
                        "unsupported correlated predicate "
                        "(both sides reference the outer query)"
                    )
                # raises with the true error if the outer side is bogus
                outer_le = self.plan_expr(outer_ast, outer_scope, ctes)
                if op is ast.BinaryOperator.EQ:
                    pairs.append((inner_ast, outer_le))
                else:
                    # inequality correlation: decorrelated through per-group
                    # MIN/MAX bounds (see _plan_correlated_exists)
                    nonequi.append((inner_ast, op, outer_le))
                continue
            raise PlanError(
                "correlated subqueries support comparison correlation only"
            )
        if not pairs:
            raise PlanError("subquery references an unknown column")
        return from_plan, inner_scope, inner_conj, pairs, nonequi

    def _correlated_subplan(self, sel, outer_scope, ctes):
        (from_plan, inner_scope, inner_conj, pairs,
         nonequi) = self._correlation_split(sel, outer_scope, ctes)
        plan = from_plan
        if inner_conj:
            pred = None
            for c in inner_conj:
                le = self.plan_expr(c, inner_scope, ctes)
                pred = le if pred is None else lp.BinaryExpr(
                    pred, lp.BinOp.AND, le
                )
            plan = lp.Filter(plan, pred)
        key_lexprs = [
            self.plan_expr(a, inner_scope, ctes) for a, _ in pairs
        ]
        outer_keys = [o for _, o in pairs]
        return plan, key_lexprs, outer_keys, nonequi

    def _plan_correlated_scalar(self, sel, outer_scope, ctes):
        items = [it for it in sel.projection if isinstance(it, ast.ExprItem)]
        if len(items) != 1 or not self._ast_has_aggregate(items[0].expr):
            raise PlanError(
                "correlated scalar subquery must select one aggregate "
                "expression"
            )
        plan, key_lexprs, outer_keys, nonequi = self._correlated_subplan(
            sel, outer_scope, ctes
        )
        if nonequi:
            raise PlanError(
                "correlated scalar subqueries support equality correlation "
                "only"
            )
        inner_scope = Resolver(plan.schema())
        if isinstance(items[0].expr, ast.Aggregate):
            # bare aggregate: the agg output column IS the value column
            agg_le = self._plan_aggregate(items[0].expr, inner_scope, ctes)
            plan = lp.Aggregate(plan, key_lexprs, [agg_le])
            miss = (
                lp.ScalarValue.int64(0)
                if agg_le.func is lp.AggFunc.COUNT else None
            )
            return lp.CorrelatedLookupExpr(
                outer_keys, plan, "value", False, miss
            )
        # expression over aggregates (TPC-H Q17/Q20: 0.2 * AVG(x)): group,
        # then project keys + the computed expression as the value column.
        # A missing group yields NULL (comparisons then reject the row).
        agg_map: Dict[str, int] = {}
        agg_exprs: List[lp.AggregateExpr] = []
        for a in self._ast_collect_aggregates(items[0].expr):
            le = self._plan_aggregate(a, inner_scope, ctes)
            key = le.name() + ("|d" if le.distinct else "")
            if key not in agg_map:
                agg_map[key] = len(agg_exprs)
                agg_exprs.append(le)
        agg_plan = lp.Aggregate(plan, key_lexprs, agg_exprs)
        agg_scope = Resolver(agg_plan.schema())
        value = self._plan_expr_agg(
            items[0].expr, agg_scope, inner_scope, key_lexprs, agg_map,
            len(key_lexprs), agg_exprs, ctes,
        )
        key_refs = [
            lp.ColumnRef(i, f.name, f.data_type, f.nullable)
            for i, f in enumerate(agg_plan.schema())
        ][: len(key_lexprs)]
        proj = lp.Projection(agg_plan, key_refs + [value])
        return lp.CorrelatedLookupExpr(outer_keys, proj, "value", False, None)

    def _plan_correlated_exists(self, sel, outer_scope, ctes, negated: bool):
        if sel.limit is not None and sel.limit == 0:
            raise PlanError("EXISTS (... LIMIT 0) is never true")
        plan, key_lexprs, outer_keys, nonequi = self._correlated_subplan(
            sel, outer_scope, ctes
        )
        if not nonequi:
            plan = lp.Aggregate(plan, key_lexprs, [])  # distinct corr keys
            return lp.CorrelatedLookupExpr(outer_keys, plan, "exists", negated)
        # One inequality correlation (TPC-H Q21: l2.l_suppkey !=
        # l1.l_suppkey): a group row satisfying `inner CMP outer` exists iff
        # the group's MIN/MAX bound does —
        #   <,<=: MIN(inner) CMP outer     >,>=: MAX(inner) CMP outer
        #   !=:   MIN != outer OR MAX != outer
        # With >1 such conjunct the per-bound tests are not jointly sound
        # (no single row need satisfy all), so reject.
        if len(nonequi) > 1:
            raise PlanError(
                "correlated subqueries support at most one inequality "
                "correlation"
            )
        inner_scope = Resolver(plan.schema())
        inner_ast, op, outer_le = nonequi[0]
        inner_le = self.plan_expr(inner_ast, inner_scope, ctes)
        B, O = lp.BinOp, ast.BinaryOperator
        aggs = []
        if op in (O.LT, O.LTE) or op is O.NEQ:
            aggs.append(lp.AggregateExpr(lp.AggFunc.MIN, inner_le))
        if op in (O.GT, O.GTE) or op is O.NEQ:
            aggs.append(lp.AggregateExpr(lp.AggFunc.MAX, inner_le))
        # ONE grouped subplan feeds every lookup (membership + bound(s));
        # the SubqueryScan wrappers share the plan object, so the shared-CTE
        # machinery (plan/lowering.py shared_subquery_ids) materializes the
        # aggregate once per query instead of once per lookup
        agg_plan = lp.Aggregate(plan, key_lexprs, aggs)
        aschema = agg_plan.schema()
        nk = len(key_lexprs)

        def scan():
            return lp.SubqueryScan(agg_plan, "__corr", aschema)

        def bound_lookup(col_idx: int):
            if col_idx == nk:
                # the value column IS the first aggregate — no projection
                return lp.CorrelatedLookupExpr(
                    outer_keys, scan(), "value", False, None
                )
            key_refs = [
                lp.ColumnRef(i, f.name, f.data_type, f.nullable)
                for i, f in enumerate(aschema)
            ][:nk]
            f = aschema.field(col_idx)
            proj = lp.Projection(scan(), key_refs + [
                lp.ColumnRef(col_idx, f.name, f.data_type, f.nullable)
            ])
            return lp.CorrelatedLookupExpr(
                outer_keys, proj, "value", False, None
            )

        if op in (O.LT, O.LTE):
            cond = lp.BinaryExpr(
                bound_lookup(nk), B.LT if op is O.LT else B.LTE, outer_le
            )
        elif op in (O.GT, O.GTE):
            cond = lp.BinaryExpr(
                bound_lookup(nk), B.GT if op is O.GT else B.GTE, outer_le
            )
        else:  # NEQ: some value differs iff a bound does
            cond = lp.BinaryExpr(
                lp.BinaryExpr(bound_lookup(nk), B.NEQ, outer_le),
                B.OR,
                lp.BinaryExpr(bound_lookup(nk + 1), B.NEQ, outer_le),
            )
        member = lp.CorrelatedLookupExpr(outer_keys, scan(), "exists", False)
        # Kleene: a missing group gives (false AND NULL) = false, so NOT
        # EXISTS over an empty correlated set is still true
        full = lp.BinaryExpr(member, B.AND, cond)
        return lp.UnaryExpr(lp.UnOp.NOT, full) if negated else full

    # ---- aggregate rewriting -------------------------------------------
    def _plan_expr_agg(
        self,
        e: ast.Expr,
        agg_scope: Resolver,
        pre_scope: Resolver,
        group_lexprs: List[lp.LogicalExpr],
        agg_map: Dict[str, int],
        num_groups: int,
        agg_exprs: List[lp.AggregateExpr],
        ctes,
    ) -> lp.LogicalExpr:
        """Plan an expr over Aggregate output: aggregates become column refs
        into the agg schema; group-key exprs become their group columns."""
        if isinstance(e, ast.Aggregate):
            le = self._plan_aggregate(e, pre_scope, ctes)
            key = le.name() + ("|d" if le.distinct else "")
            idx = num_groups + agg_map[key]
            return lp.ColumnRef(idx, le.name(), le.dtype, le.nullable)
        if isinstance(e, ast.GroupingCall):
            try:
                gcol = agg_scope.resolve("__grouping")
            except PlanError:
                raise PlanError(
                    "GROUPING() requires ROLLUP/CUBE/GROUPING SETS"
                )
            out = None
            n = len(e.args)
            for j, a in enumerate(e.args):
                cand = self.plan_expr(a, pre_scope, ctes)
                gi = next(
                    (i for i, g in enumerate(group_lexprs)
                     if self._expr_eq(cand, g)),
                    None,
                )
                if gi is None:
                    raise PlanError(
                        "GROUPING() arguments must be grouping keys"
                    )
                lit = lambda v: lp.Literal(lp.ScalarValue.int64(v))
                bit = lp.BinaryExpr(
                    lp.BinaryExpr(gcol, lp.BinOp.DIV, lit(1 << gi)),
                    lp.BinOp.MOD, lit(2),
                )
                w = 1 << (n - 1 - j)
                term = bit if w == 1 else lp.BinaryExpr(
                    bit, lp.BinOp.MUL, lit(w)
                )
                out = term if out is None else lp.BinaryExpr(
                    out, lp.BinOp.ADD, term
                )
            return out
        # group expr structural match
        try:
            candidate = self.plan_expr(e, pre_scope, ctes)
            for gi, g in enumerate(group_lexprs):
                if self._expr_eq(candidate, g):
                    f = agg_scope.schema.field(gi)
                    return lp.ColumnRef(gi, f.name, f.data_type, f.nullable)
        except PlanError:
            pass
        # recurse
        if isinstance(e, ast.BinaryOp):
            left = self._plan_expr_agg(
                e.left, agg_scope, pre_scope, group_lexprs, agg_map,
                num_groups, agg_exprs, ctes,
            )
            right = self._plan_expr_agg(
                e.right, agg_scope, pre_scope, group_lexprs, agg_map,
                num_groups, agg_exprs, ctes,
            )
            return lp.BinaryExpr(left, _BINOP_MAP[e.op], right)
        if isinstance(e, ast.UnaryOp):
            inner = self._plan_expr_agg(
                e.expr, agg_scope, pre_scope, group_lexprs, agg_map,
                num_groups, agg_exprs, ctes,
            )
            op = lp.UnOp.NOT if e.op is ast.UnaryOperator.NOT else lp.UnOp.NEG
            return lp.UnaryExpr(op, inner)
        if isinstance(e, ast.Cast):
            inner = self._plan_expr_agg(
                e.expr, agg_scope, pre_scope, group_lexprs, agg_map,
                num_groups, agg_exprs, ctes,
            )
            return lp.CastExpr(inner, e.data_type)
        if isinstance(e, ast.QuantifiedComparison):
            # the LEFT operand rewrites post-agg (SUM(x) > ALL (...));
            # the subquery body is its own scope, planned normally
            inner = self._plan_expr_agg(
                e.expr, agg_scope, pre_scope, group_lexprs, agg_map,
                num_groups, agg_exprs, ctes,
            )
            sub = self.plan_select(e.query, ctes)
            if len(sub.schema()) != 1:
                raise PlanError(
                    "quantified comparison subquery must return one column"
                )
            B = ast.BinaryOperator
            if e.op is B.EQ and e.is_any:
                return lp.InSubqueryExpr(inner, sub, False)
            if e.op is B.NEQ and not e.is_any:
                return lp.InSubqueryExpr(inner, sub, True)
            m = {B.EQ: lp.BinOp.EQ, B.NEQ: lp.BinOp.NEQ,
                 B.LT: lp.BinOp.LT, B.LTE: lp.BinOp.LTE,
                 B.GT: lp.BinOp.GT, B.GTE: lp.BinOp.GTE}
            if e.op not in m:
                raise PlanError(
                    f"operator {e.op.value} cannot be quantified with ANY/ALL"
                )
            return lp.QuantifiedCmpExpr(inner, m[e.op], e.is_any, sub)
        if isinstance(e, (ast.NumberLit, ast.StringLit, ast.BoolLit, ast.NullLit)):
            return self.plan_expr(e, agg_scope, ctes)

        def rec(x):
            return self._plan_expr_agg(
                x, agg_scope, pre_scope, group_lexprs, agg_map,
                num_groups, agg_exprs, ctes,
            )

        if isinstance(e, ast.ScalarFunctionCall):
            # scalar functions OVER aggregate results: ROUND(AVG(x), 2),
            # ARRAY_TO_STRING(ARRAY_AGG(x), ',') — rewrite the arguments
            if e.func is ast.ScalarFunction.PI:
                return self.plan_expr(e, agg_scope, ctes)
            if e.func is ast.ScalarFunction.MOD:
                return lp.BinaryExpr(
                    rec(e.args[0]), lp.BinOp.MOD, rec(e.args[1])
                )
            return lp.ScalarFnExpr(
                lp.ScalarFn[e.func.name], [rec(a) for a in e.args]
            )
        if isinstance(e, ast.Case) and e.operand is None:
            return lp.CaseExpr(
                [(rec(w), rec(t)) for w, t in e.branches],
                rec(e.else_expr) if e.else_expr is not None else None,
            )
        if isinstance(e, ast.IsNull):
            return lp.IsNullExpr(rec(e.expr), e.negated)
        # plain columns: must be group keys (checked above) — or resolvable
        # in the aggregate output schema directly
        return self.plan_expr(e, agg_scope, ctes)

    @staticmethod
    def _expr_eq(a: lp.LogicalExpr, b: lp.LogicalExpr) -> bool:
        if type(a) is not type(b):
            return False
        if isinstance(a, lp.ColumnRef):
            return a.index == b.index
        return a == b

    # ---- AST aggregate/window scanning ---------------------------------
    @classmethod
    def _ast_has_aggregate(cls, e: ast.Expr) -> bool:
        return bool(cls._ast_collect_aggregates(e))

    @classmethod
    def _ast_collect_aggregates(cls, e: ast.Expr) -> List[ast.Aggregate]:
        out: List[ast.Aggregate] = []

        def visit(x):
            if isinstance(x, ast.Aggregate):
                out.append(x)
                return  # don't descend into aggregate args
            for c in cls._ast_children(x):
                visit(c)

        visit(e)
        return out

    @classmethod
    def _ast_collect_windows(cls, e: ast.Expr, out: List[ast.Expr]) -> None:
        if isinstance(e, (ast.WindowFunction, ast.WindowAggregate)):
            out.append(e)
            return
        for c in cls._ast_children(e):
            cls._ast_collect_windows(c, out)

    @staticmethod
    def _ast_children(e: ast.Expr) -> Sequence[ast.Expr]:
        if isinstance(e, ast.BinaryOp):
            return (e.left, e.right)
        if isinstance(e, ast.UnaryOp):
            return (e.expr,)
        if isinstance(e, ast.Cast):
            return (e.expr,)
        if isinstance(e, ast.Aggregate):
            kids = [e.expr] if e.expr2 is None else [e.expr, e.expr2]
            kids += [ob.expr for ob in e.agg_order_by]
            if e.filter is not None:
                kids.append(e.filter)
            return tuple(kids)
        if isinstance(e, ast.GroupingCall):
            return ()  # args are key references, not value expressions
        if isinstance(e, ast.WindowAggregate):
            # NOT an ast.Aggregate: must not trigger GROUP BY detection;
            # its arg may contain real grouped aggregates (SUM(SUM(x)) OVER)
            return (e.arg,) if e.arg is not None else ()
        if isinstance(e, (ast.ScalarFunctionCall, ast.UdfCall)):
            return tuple(e.args)
        if isinstance(e, ast.Case):
            kids = []
            if e.operand is not None:
                kids.append(e.operand)
            for w, t in e.branches:
                kids += [w, t]
            if e.else_expr is not None:
                kids.append(e.else_expr)
            return tuple(kids)
        if isinstance(e, ast.InList):
            return (e.expr,) + tuple(e.items)
        if isinstance(e, (ast.IsNull,)):
            return (e.expr,)
        if isinstance(e, ast.Between):
            return (e.expr, e.low, e.high)
        if isinstance(e, (ast.InSubquery,)):
            return (e.expr,)
        if isinstance(e, ast.QuantifiedComparison):
            return (e.expr,)  # the subquery body is its own scope
        if isinstance(e, ast.WindowFunction):
            return tuple(e.args) + tuple(e.over.partition_by) + tuple(
                ob.expr for ob in e.over.order_by
            )
        return ()
