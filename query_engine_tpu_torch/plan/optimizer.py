"""Logical plan optimizer.

Parity surface: reference crates/query-planner/src/optimizer.rs:5-69 — an
OptimizationRule list with PredicatePushdown and ProjectionPushdown. The
reference's PredicatePushdown handles exactly one shape (Filter over
Projection, non-recursive) and its ProjectionPushdown is a no-op; SURVEY.md
§7 asks for "the two pushdown rules done properly", so here they are real:

* PredicatePushdown — recursive; swaps Filter through Projection (with
  expression substitution), merges adjacent Filters, and pushes single-side
  conjuncts below a Join into the matching input.
* ProjectionPushdown — prunes TableScan columns to the set actually used
  upstream, rewriting column indices.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Set

from query_engine_tpu_torch.plan import logical as lp


class OptimizationRule:
    name = "rule"

    def apply(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        raise NotImplementedError


def _substitute(expr: lp.LogicalExpr, mapping: List[lp.LogicalExpr]) -> lp.LogicalExpr:
    """Replace ColumnRef(i) with mapping[i] (deep copy)."""
    e = copy.deepcopy(expr)

    def rewrite(x: lp.LogicalExpr) -> lp.LogicalExpr:
        if isinstance(x, lp.ColumnRef):
            return copy.deepcopy(mapping[x.index])
        for attr in ("left", "right", "expr"):
            if hasattr(x, attr):
                child = getattr(x, attr)
                if isinstance(child, lp.LogicalExpr):
                    setattr(x, attr, rewrite(child))
        if hasattr(x, "args"):
            x.args = [rewrite(a) for a in x.args]
        if hasattr(x, "items"):
            x.items = [rewrite(a) for a in x.items]
        if isinstance(x, lp.CaseExpr):
            x.branches = [(rewrite(c), rewrite(v)) for c, v in x.branches]
            if x.else_expr is not None:
                x.else_expr = rewrite(x.else_expr)
        return x

    return rewrite(e)


def _shift_columns(expr: lp.LogicalExpr, delta: int) -> lp.LogicalExpr:
    e = copy.deepcopy(expr)
    seen = set()  # shared subexprs (e.g. BETWEEN's operand) mutate ONCE

    def fix(x):
        if isinstance(x, lp.ColumnRef) and id(x) not in seen:
            seen.add(id(x))
            x.index += delta

    lp.walk_exprs(e, fix)
    return e


def _max_column(expr: lp.LogicalExpr) -> int:
    hi = -1

    def visit(x):
        nonlocal hi
        if isinstance(x, lp.ColumnRef):
            hi = max(hi, x.index)

    lp.walk_exprs(expr, visit)
    return hi


def _split_and(e: lp.LogicalExpr) -> List[lp.LogicalExpr]:
    if isinstance(e, lp.BinaryExpr) and e.op is lp.BinOp.AND:
        return _split_and(e.left) + _split_and(e.right)
    return [e]


def _conjoin(parts: List[lp.LogicalExpr]) -> Optional[lp.LogicalExpr]:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = lp.BinaryExpr(out, lp.BinOp.AND, p)
    return out


def _has_subquery_or_window(e: lp.LogicalExpr) -> bool:
    found = []

    def visit(x):
        if isinstance(
            x,
            (lp.ScalarSubqueryExpr, lp.InSubqueryExpr, lp.ExistsExpr,
             lp.WindowExpr, lp.AggregateExpr),
        ):
            found.append(x)

    lp.walk_exprs(e, visit)
    return bool(found)


class PredicatePushdown(OptimizationRule):
    name = "predicate_pushdown"

    def apply(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        plan = self._rewrite_children(plan)
        if not isinstance(plan, lp.Filter):
            return plan

        child = plan.input
        pred = plan.predicate

        # merge adjacent filters
        if isinstance(child, lp.Filter):
            merged = lp.Filter(
                child.input, lp.BinaryExpr(child.predicate, lp.BinOp.AND, pred)
            )
            return self.apply(merged)

        # swap through projection (only when the predicate is substitutable)
        if isinstance(child, lp.Projection) and not _has_subquery_or_window(pred):
            ok = all(
                not isinstance(e, (lp.WindowExpr,)) for e in child.exprs
            )
            if ok:
                inner_pred = _substitute(pred, child.exprs)
                pushed = lp.Filter(child.input, inner_pred)
                return lp.Projection(self.apply(pushed), child.exprs)

        # push single-side conjuncts below inner joins
        if isinstance(child, lp.Join) and child.join_type is lp.JoinType.INNER:
            n_left = len(child.left.schema())
            left_parts, right_parts, keep = [], [], []
            for c in _split_and(pred):
                if _has_subquery_or_window(c):
                    keep.append(c)
                    continue
                hi = _max_column(c)
                refs_left = self._min_column(c) < n_left
                refs_right = hi >= n_left
                if refs_left and not refs_right:
                    left_parts.append(c)
                elif refs_right and not refs_left:
                    right_parts.append(c)
                else:
                    keep.append(c)
            if left_parts or right_parts:
                new_left = child.left
                new_right = child.right
                lp_pred = _conjoin(left_parts)
                if lp_pred is not None:
                    new_left = self.apply(lp.Filter(new_left, lp_pred))
                rp = _conjoin(
                    [_shift_columns(c, -n_left) for c in right_parts]
                )
                if rp is not None:
                    new_right = self.apply(lp.Filter(new_right, rp))
                new_join = lp.Join(new_left, new_right, child.join_type, child.on)
                rest = _conjoin(keep)
                return lp.Filter(new_join, rest) if rest is not None else new_join
        return plan

    @staticmethod
    def _min_column(expr: lp.LogicalExpr) -> int:
        lo = 1 << 30

        def visit(x):
            nonlocal lo
            if isinstance(x, lp.ColumnRef):
                lo = min(lo, x.index)

        lp.walk_exprs(expr, visit)
        return lo

    def _rewrite_children(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        for attr in ("input", "left", "right"):
            if hasattr(plan, attr):
                child = getattr(plan, attr)
                if isinstance(child, lp.LogicalPlan):
                    setattr(plan, attr, self.apply(child))
        return plan


class ProjectionPushdown(OptimizationRule):
    """Prune unused TableScan columns, rewriting upstream column indices."""

    name = "projection_pushdown"

    def apply(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        # recurse first
        for attr in ("input", "left", "right"):
            if hasattr(plan, attr):
                child = getattr(plan, attr)
                if isinstance(child, lp.LogicalPlan):
                    setattr(plan, attr, self.apply(child))

        # Projection over a full TableScan — possibly through a chain of
        # Filters — restricts the scan to the used columns.
        if isinstance(plan, lp.Projection):
            filters: List[lp.Filter] = []
            node = plan.input
            while isinstance(node, lp.Filter):
                filters.append(node)
                node = node.input
            if not isinstance(node, lp.TableScan) or node.projection is not None:
                return plan
            scan = node
            used: Set[int] = set()

            def collect(x):
                if isinstance(x, lp.ColumnRef):
                    used.add(x.index)

            for e in plan.exprs:
                lp.walk_exprs(e, collect)
            for f in filters:
                lp.walk_exprs(f.predicate, collect)
            if len(used) >= len(scan.table_schema) or not used:
                return plan
            keep = sorted(used)
            remap = {old: new for new, old in enumerate(keep)}

            def remapped(e):
                e2 = copy.deepcopy(e)
                seen = set()  # shared subexprs mutate once

                def fix(x):
                    if isinstance(x, lp.ColumnRef) and id(x) not in seen:
                        seen.add(id(x))
                        x.index = remap[x.index]

                lp.walk_exprs(e2, fix)
                return e2

            rebuilt: lp.LogicalPlan = lp.TableScan(
                scan.table_name, scan.table_schema, keep
            )
            for f in reversed(filters):
                rebuilt = lp.Filter(rebuilt, remapped(f.predicate))
            return lp.Projection(rebuilt, [remapped(e) for e in plan.exprs])
        return plan


class Optimizer:
    """Rule pipeline (reference optimizer.rs:16-24)."""

    def __init__(self, rules: Optional[List[OptimizationRule]] = None):
        self.rules = rules if rules is not None else [
            PredicatePushdown(),
            ProjectionPushdown(),
        ]

    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        for rule in self.rules:
            plan = rule.apply(plan)
        return plan
