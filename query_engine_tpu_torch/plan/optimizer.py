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

A third rule runs before them, with no counterpart in the JAX package
(which plans a FROM list as CROSS joins under a Filter; rows agree, plans
differ):

* CommaJoins — a Filter over a tree of CROSS joins made from a FROM list
  (`FROM a, b, c WHERE ...`) becomes a tree of INNER equi-joins. A conjunct
  `x = y` between columns of two items keys the join that first brings both
  together; items join largest first (the session's row counts), each next
  one the largest that a key connects, so a fact table probes and its
  dimensions build, as the explicit `JOIN ... ON` texts put them; a
  conjunct over one item filters that item; any other conjunct over
  several items filters the lowest join that covers them; a conjunct with
  a subquery stays above the whole tree, over a projection that restores
  the FROM list's column order, as PredicatePushdown keeps it above an
  explicit join; a decorrelated lookup is placed as any other conjunct over
  its columns, but never keys a join.
  Conjuncts common to every branch of an OR are factored out first (TPC-H
  Q19's join key). Items that nothing connects stay CROSS; an explicit
  `JOIN ... ON` is one item, never reordered. Subquery plans inside
  expressions are rewritten too.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Set

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


def _split_or(e: lp.LogicalExpr) -> List[lp.LogicalExpr]:
    if isinstance(e, lp.BinaryExpr) and e.op is lp.BinOp.OR:
        return _split_or(e.left) + _split_or(e.right)
    return [e]


def _same(a: lp.LogicalExpr, b: lp.LogicalExpr) -> bool:
    try:
        return bool(a == b)
    except Exception:  # an expression whose fields do not compare
        return False


def _factor_or(conjuncts: List[lp.LogicalExpr]) -> List[lp.LogicalExpr]:
    """Each OR's conjuncts common to all of its branches pulled out beside
    it: (A AND B) OR (A AND C) is A AND (B OR C); a WHERE clause keeps a row
    only where both are TRUE, so NULLs do not tell them apart."""
    out = []
    for c in conjuncts:
        branches = [_split_and(b) for b in _split_or(c)]
        if len(branches) < 2:
            out.append(c)
            continue
        common = [x for x in branches[0]
                  if all(any(_same(x, y) for y in b) for b in branches[1:])]
        if not common:
            out.append(c)
            continue
        rests = [[y for y in b if not any(_same(y, x) for x in common)]
                 for b in branches]
        out.extend(common)
        if all(rests):  # a branch left empty makes the OR TRUE
            ors = [_conjoin(r) for r in rests]
            rest = ors[0]
            for o in ors[1:]:
                rest = lp.BinaryExpr(rest, lp.BinOp.OR, o)
            out.append(rest)
    return out


def _remap(expr: lp.LogicalExpr, mapping) -> lp.LogicalExpr:
    """A copy of expr with each ColumnRef(i) at mapping[i]."""
    e = copy.deepcopy(expr)
    seen = set()  # shared subexprs mutate once

    def fix(x):
        if isinstance(x, lp.ColumnRef) and id(x) not in seen:
            seen.add(id(x))
            x.index = mapping[x.index]

    lp.walk_exprs(e, fix)
    return e


def _columns(expr: lp.LogicalExpr) -> Set[int]:
    cols: Set[int] = set()
    lp.walk_exprs(expr, lambda x: cols.add(x.index)
                  if isinstance(x, lp.ColumnRef) else None)
    return cols


def _is_comma(plan: lp.LogicalPlan) -> bool:
    return (isinstance(plan, lp.Join) and plan.join_type is lp.JoinType.CROSS
            and plan.on is None)


def _comma_items(plan: lp.LogicalPlan) -> List[lp.LogicalPlan]:
    """The items of a tree of CROSS joins, left to right."""
    if _is_comma(plan):
        return _comma_items(plan.left) + _comma_items(plan.right)
    return [plan]


def _subquery_exprs(node) -> List[lp.LogicalExpr]:
    """The subquery expressions (those holding a `plan`, a decorrelated
    lookup's too) among a plan node's expressions, or within an
    expression."""
    found: List[lp.LogicalExpr] = []
    stack = [node] if isinstance(node, lp.LogicalExpr) else [
        v for k, v in vars(node).items() if k not in ("input", "left",
                                                       "right")]
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, lp.SortKey):
            stack.append(v.expr)
        elif isinstance(v, lp.LogicalExpr):
            lp.walk_exprs(v, lambda x: found.append(x)
                          if isinstance(getattr(x, "plan", None),
                                        lp.LogicalPlan) else None)
    return found


class CommaJoins(OptimizationRule):
    """A FROM list's CROSS joins under a Filter as INNER equi-joins (the
    module docstring). `table_rows(name)` gives a table's row count, or
    None where it is not known."""

    name = "comma_joins"

    def __init__(self, table_rows: Optional[Callable] = None):
        self.table_rows = table_rows or (lambda name: None)

    def apply(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        return self._apply(plan, {})

    def _apply(self, plan: lp.LogicalPlan, done: dict) -> lp.LogicalPlan:
        if id(plan) in done:  # a plan shared by several references
            return done[id(plan)]
        done[id(plan)] = plan
        for attr in ("input", "left", "right"):
            child = getattr(plan, attr, None)
            if isinstance(child, lp.LogicalPlan):
                setattr(plan, attr, self._apply(child, done))
        for sub in _subquery_exprs(plan):
            sub.plan = self._apply(sub.plan, done)
        if isinstance(plan, lp.Filter) and _is_comma(plan.input):
            done[id(plan)] = self._rebuild(plan)
        return done[id(plan)]

    def _rows(self, item: lp.LogicalPlan) -> int:
        if isinstance(item, lp.TableScan):
            n = self.table_rows(item.table_name)
            if n is not None:
                return int(n)
        return -1

    def _rebuild(self, f: lp.Filter) -> lp.LogicalPlan:
        items = _comma_items(f.input)
        n = len(items)
        widths = [len(it.schema()) for it in items]
        offs = [sum(widths[:i]) for i in range(n)]
        owner = [i for i in range(n) for _ in range(widths[i])]
        top: List[lp.LogicalExpr] = []
        local: List[List[lp.LogicalExpr]] = [[] for _ in range(n)]
        edges = []   # (item a, item b, expr on a, expr on b)
        multi = []   # (items, conjunct)
        for c in _factor_or(_split_and(f.predicate)):
            its = {owner[i] for i in _columns(c)}
            if _has_subquery_or_window(c) or not its:
                top.append(c)
            elif len(its) == 1:
                (i,) = its
                local[i].append(_shift_columns(c, -offs[i]))
            else:
                sides = None
                if isinstance(c, lp.BinaryExpr) and c.op is lp.BinOp.EQ \
                        and not _subquery_exprs(c):
                    a = {owner[i] for i in _columns(c.left)}
                    b = {owner[i] for i in _columns(c.right)}
                    if len(a) == 1 and len(b) == 1 and a != b:
                        sides = (a.pop(), b.pop())
                if sides is not None:
                    edges.append((sides[0], sides[1], c.left, c.right))
                else:
                    multi.append((its, c))

        rows = [self._rows(it) for it in items]

        def biggest(cands):
            return max(cands, key=lambda i: (rows[i], -i))

        def linked(j, joined):
            return any((a == j and b in joined) or (b == j and a in joined)
                       for a, b, _, _ in edges)

        def scan(i):
            p = items[i]
            return lp.Filter(p, _conjoin(local[i])) if local[i] else p

        order = [biggest(range(n))]
        joined = {order[0]}
        pos = {offs[order[0]] + k: k for k in range(widths[order[0]])}
        tree = scan(order[0])
        placed: Set[int] = set()
        while len(order) < n:
            rest = [j for j in range(n) if j not in joined]
            j = biggest([k for k in rest if linked(k, joined)] or rest)
            n_left = len(tree.schema())
            right_pos = {offs[j] + k: n_left + k for k in range(widths[j])}
            merged = {**pos, **right_pos}
            keys = []
            for a, b, ea, eb in edges:
                if (a == j and b in joined) or (b == j and a in joined):
                    lhs, rhs = (eb, ea) if a == j else (ea, eb)
                    keys.append(lp.BinaryExpr(_remap(lhs, merged), lp.BinOp.EQ,
                                              _remap(rhs, merged)))
            tree = lp.Join(tree, scan(j),
                           lp.JoinType.INNER if keys else lp.JoinType.CROSS,
                           _conjoin(keys))
            order.append(j)
            joined.add(j)
            pos = merged
            ready = [k for k, (its, _) in enumerate(multi)
                     if k not in placed and its <= joined]
            if ready:
                placed.update(ready)
                tree = lp.Filter(tree, _conjoin(
                    [_remap(multi[k][1], pos) for k in ready]))
        if order != list(range(n)):
            # the FROM list's column order, for everything above
            fields = f.input.schema().fields
            tree = lp.Projection(tree, [
                lp.ColumnRef(pos[i], fd.name, fd.data_type, fd.nullable)
                for i, fd in enumerate(fields)])
        return lp.Filter(tree, _conjoin(top)) if top else tree


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

    def __init__(self, rules: Optional[List[OptimizationRule]] = None,
                 table_rows: Optional[Callable] = None):
        self.rules = rules if rules is not None else [
            CommaJoins(table_rows),
            PredicatePushdown(),
            ProjectionPushdown(),
        ]

    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        for rule in self.rules:
            plan = rule.apply(plan)
        return plan
