"""Compiled query pipelines: a maximal plan segment as ONE static program.

The counterpart of `query_engine_tpu.engine.pipeline`, for the main path's
operators. Eager execution (engine/executor.py) reads a row count from the
device after every size-changing operator to pick the next capacity. A
compiled segment instead threads a *selection mask* through the segment:

    filter                sel &= predicate(cols)           (no compaction)
    LIMIT / OFFSET        sel &= rank window over sel      (no compaction)
    projection            new planes, sel unchanged
    sort                  planes gathered by permutation; sel = prefix mask
    aggregate             segment-reduce into a statically bounded group
                          space; sel = prefix mask (or observed buckets)
    INNER FK join         build side gathered by rank; sel &= matched

so a scan->filter->join->aggregate->sort->limit query is one program body
of torch ops at static capacities that reads nothing from the device,
followed by ONE host read of the result's row count (and one compaction
when the surviving rows are not front-packed).

What replaces `jax.jit`: programs are cached by (plan structure, leaf
capacities/dtypes/dictionary identities/bucketed column bounds, join
resolutions). On a CPU device a cached program re-runs its body on each
call. On a CUDA device its first call runs the body eagerly (which also
records the output's schema) and then captures the body into a
`torch.cuda.CUDAGraph`; later calls write the leaf row counts and the
literal values into the program's input buffers and replay the graph. A
graph reads the leaf planes at the addresses it was captured with, so the
entry keeps those tensors alive and captures again when a leaf's planes
change (a table registered anew); results are returned as copies, since
the next replay overwrites the graph's outputs.

Equi-joins (INNER, LEFT, RIGHT, FULL, with or without a residual ON
condition) trace in-segment when one side's key multiplicity has a known
provenance. A unique side (a GROUP BY below the key, or a cached
multiplicity stat of 1 on a leaf column) takes the FK fast paths; a side
whose stat is at most 16 emits at the static capacity probe rows x its
bucketed multiplicity (1/2/4/8/16) plus the outer rows' slots. A join with
no such bound, or one whose static emit would pass 2^26 slots, goes
through the count->emit capacity sync: a COUNT program (the same segment,
stopped at that join by `_CountReady`) returns the join's output size, the
host reads that one scalar and the EMIT program runs the join at its pow2
bucket, reusing the count program's joint sort (its sorted planes are
emit-program inputs). An aggregate whose group keys carry no static range
(a computed or float key) counts its groups the same way and aggregates
at padded(ng) with the count program's group ids. A join is demoted to an
eager leaf only when its count program fails or its counted size passes
2^26; the segment above it still compiles, with the join's result fed in
as a leaf batch. GROUP BY keys that a unique-side join makes functions of
another group key are dropped from the grouping (`_fd_dependent_keys`).
A derived table (a subquery in FROM) is a pass-through node that renames
its child's columns. Window functions, DISTINCT and set operations trace
too, all at their input's capacity with a selection mask: a window sorts
once per OVER spec (specs whose ORDER BY extends another's share its sort
when the function cannot see the order within peers) and gathers its
values back through the inverse permutation; DISTINCT and INTERSECT/EXCEPT
keep the first row of each key (INTERSECT/EXCEPT after a rank-membership
test against the right side); UNION [ALL] concatenates the two sides'
planes. On CUDA a set operation over string columns is an eager leaf when
its two dictionaries merge into a table built on the host (`unify_dicts`),
which a graph cannot capture; a grouping set's UNION ALL, whose string keys
come from one table's column or are NULL, shares one dictionary and stays
in the program (`_setop_shares_dicts`). A shared WITH query (referenced
more than once) is a leaf boundary: the executor materializes it once per
query and every reference reads that batch. A subquery expression's plan
runs eagerly before the program runs or is captured, and its result batch
is one more program input, read in the body through
`Evaluator._subplans`: a program never runs a plan. Constructs outside the
slice (CROSS joins, joins on keys of unknown provenance, VALUES,
generate_series, UDF calls, || and the expressions `_expr_traceable` keeps
out) raise
_Unsupported and run eagerly, per subtree. On CUDA so do the expressions
that build a table on the host (string comparisons, string IN, LIKE and
the regex operators, the string, regex and JSON functions, string casts,
string-keyed subqueries: `expr_eval.builds_host_table`); a date compared
with a string literal is not one of them, since the parsed literal
(`expr_eval.temporal_literal`) is a program input, and neither are the
numeric and date functions (%, ROUND, SQRT, COALESCE, DATE_TRUNC, INTERVAL
arithmetic, decimals). An argument the host reads while the program is
built (ROUND's digits, SUBSTRING's start, a JSON key) keys the program by
value (`_static_operands`).

The eager executor is the semantics oracle (tests/test_torch_pipeline.py).
"""

from __future__ import annotations

import collections
import gc
import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.core.schema import Schema
from query_engine_tpu_torch.core.types import TypeKind
from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, padded_capacity,
)
from query_engine_tpu_torch.engine import window as W
from query_engine_tpu_torch.engine.expr_eval import (
    LIST_FNS, Val, builds_host_table, static_json_key,
    temporal_literal, unify_dicts,
)
from query_engine_tpu_torch.ops import group_agg, small_gather
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp


class _Unsupported(Exception):
    """Raised during segment analysis/tracing: run the subtree eagerly."""


class _CountReady(Exception):
    """Raised inside a COUNT program's body by the join (or aggregate) it
    counts: carries that node's output size, a 0-d device tensor, up to
    the body, which returns it with `extras`: the planes the emit program
    reuses, the joint sort's (sperm, sorted_lead, change) or the grouping's
    (gid, ng, rep); () when there is nothing to reuse (direct ranks)."""

    def __init__(self, node, count, extras=()):
        super().__init__("join count ready")
        self.node = node
        self.count = count
        self.extras = extras


# the largest emit the pipeline allocates, in rows: a static emit bound
# (probe capacity x multiplicity bucket) above it counts instead, and a
# counted size above it demotes the join to an eager leaf
_MAX_EMIT = 1 << 26


# failures of a program body that mean "not for this slice" — run eagerly.
# Device and capture errors (RuntimeError) are not among them: they raise.
_TRACE_ERRORS = (_Unsupported, NotImplementedError, ExecutionError)
# held by a CUDA graph capture, of any Session (`_capture`)
_CAPTURE_LOCK = threading.RLock()


@dataclass
class _TTable:
    """A table inside a program body: column planes at a static capacity
    plus a boolean selection mask. `dense` is statically known: the
    selected rows are a prefix (sel == live_mask(cap, count)), so no
    compaction is needed. `bounds[i]` is a static conservative (lo,
    bucket_range) cover of integer column i's values (None if unknown) — it
    survives filter/sort/limit and enables sort-free direct grouping and
    direct join ranks without a host read."""

    schema: Schema
    cols: List[Column]
    sel: torch.Tensor
    capacity: int
    dense: bool
    bounds: List[Optional[Tuple[int, int]]]


# ---------------------------------------------------------------------------
# table statistics, cached on the Column objects of stored tables. `host` is
# the executor's counted device-to-host read (QueryExecutor._host_list).
# ---------------------------------------------------------------------------


def _is_int(t: torch.Tensor) -> bool:
    return not t.is_floating_point() and t.dtype != torch.bool


def ensure_bounds(batch: ColumnBatch, host) -> None:
    """Populate the integer-column bounds caches: ONE fused min/max
    reduction over the batch's uncached integer columns and one host read
    of the results."""
    pending = []
    for c in batch.columns:
        if getattr(c, "_qe_bounds", False) is not False:
            continue
        if c.dictionary is not None or not _is_int(c.data):
            c._qe_bounds = (0, 1) if c.data.dtype == torch.bool else None
        else:
            pending.append(c)
    if not pending:
        return
    mm = torch.stack([
        torch.stack([c.data.min().to(torch.int64),
                     c.data.max().to(torch.int64)])
        for c in pending
    ])
    for c, (lo, hi) in zip(pending, host(mm)):
        c._qe_bounds = (int(lo), int(hi))


def _col_bounds(col) -> Optional[Tuple[int, int]]:
    """Cached raw (min, max) over an integer column's full data plane
    (padding included — a conservative cover is all direct grouping needs);
    (0, 1) for bools, None for other columns and before ensure_bounds."""
    return getattr(col, "_qe_bounds", None)


def _bucket_bounds(b: Optional[Tuple[int, int]]):
    """Quantize raw bounds to (lo floored to 128, pow2 range) so appends
    within the bucket reuse the compiled program. Ranges too large for
    direct grouping collapse to a single sentinel."""
    if b is None:
        return None
    lo, hi = b
    lo_b = (lo >> 7) << 7
    rng = hi - lo_b + 1
    if rng > (1 << 21):  # _DIRECT_GROUP_MAX_RANGE
        return ("big",)
    return (lo_b, padded_capacity(rng))


def _device_max_dup(cols, num_rows: int, host) -> int:
    """Max multiplicity of the live fully-valid key tuple, computed on the
    device (a stable lexicographic sort + run lengths) with one host read."""
    cap = cols[0].data.shape[0]
    dev = cols[0].data.device
    okall = K.live_mask(cap, num_rows, dev)
    for c in cols:
        okall = okall & c.validity
    ops = [(~okall).to(torch.int32)]
    for c in cols:
        key = K.orderable_i64(c.data)
        ops.append(torch.where(okall, key, torch.zeros_like(key)))
    perm = K._lexsort(ops)
    keys_sorted = [o[perm] for o in ops]
    ok_sorted = okall[perm]
    idx = torch.arange(cap, device=dev)
    change = idx == 0
    for k2 in keys_sorted:
        change = change | ((idx > 0) & (k2 != torch.roll(k2, 1)))
    runlen = K._seg_end_pos(change) - K._seg_start_pos(change) + 1
    d = host(torch.where(ok_sorted, runlen, 0).max())
    return max(int(d), 1)


def _col_max_dup(col, num_rows: int, host) -> int:
    """Cached: maximum multiplicity of any live valid value in the column
    (1 == unique). Subsetting (filter/limit) can only shrink
    multiplicities, so the stat computed on a leaf batch stays a valid
    bound anywhere above it in the plan."""
    cached = getattr(col, "_qe_max_dup", None)
    if cached is not None and cached[0] == num_rows:
        return cached[1]
    d = _device_max_dup([col], num_rows, host)
    col._qe_max_dup = (num_rows, d)
    return d


def _cols_max_dup(batch, idxs, host) -> int:
    """Multi-column variant of _col_max_dup: max multiplicity of any live
    fully-valid key TUPLE (cached on the first key column)."""
    first = batch.columns[idxs[0]]
    cache = getattr(first, "_qe_tuple_max_dup", None)
    key = (tuple(idxs), batch.num_rows)
    if cache is not None and key in cache:
        return cache[key]
    d = _device_max_dup([batch.columns[i] for i in idxs], batch.num_rows,
                        host)
    if cache is None:
        cache = {}
        first._qe_tuple_max_dup = cache
    cache[key] = d
    return d


def _dup_bucket(d: int):
    """Bucket a max-duplication stat to {1,2,4,8,16}; above that the emit
    capacity blowup isn't worth it."""
    for b in (1, 2, 4, 8, 16):
        if d <= b:
            return b
    return None


def _mxu_gather_ok(src_capacity: int, enabled: bool) -> bool:
    """The small-table gather route (ops/small_gather.py) for a build side
    of at most small_gather.MAX_TABLE rows, when the session enabled it
    (QE_MXU_GATHER=1)."""
    return enabled and src_capacity <= small_gather.MAX_TABLE


def _key_ranges(exprs, vals, t):
    """Per-sort-key static (lo, range) covers: dictionary sizes or
    table-stat bounds for bare columns; None disables composite packing."""
    out = []
    for e, v in zip(exprs, vals):
        if v.dictionary is not None:
            out.append((0, max(len(v.dictionary), 1)))
        else:
            out.append(_proj_bounds(e, t))
    return out


def _gather_bounds(t: _TTable):
    """Per-column static covers for gather_columns_packed: table-stat
    bounds where tracked, dictionary sizes for dict columns."""
    out = []
    for c, b in zip(t.cols, t.bounds):
        if c.dictionary is not None:
            out.append((0, max(len(c.dictionary), 1)))
        else:
            out.append(b)
    return out


def _proj_bounds(e: lp.LogicalExpr, t: _TTable):
    """Bounds survive a projection only for bare column references."""
    if isinstance(e, lp.AliasExpr):
        e = e.expr
    if isinstance(e, lp.ColumnRef) and e.index < len(t.bounds):
        return t.bounds[e.index]
    return None


def _group_key_bounds(e: lp.LogicalExpr, t: _TTable):
    """Static (lo, range) cover for a group-key expression, if known."""
    return _proj_bounds(e, t)


class _ShimBatch:
    """Duck-typed ColumnBatch over a program's planes for Evaluator calls."""

    __slots__ = ("schema", "columns", "num_rows", "capacity")

    def __init__(self, t: _TTable):
        self.schema = t.schema
        self.columns = t.cols
        self.capacity = t.capacity
        self.num_rows = t.sel  # kernels accept masks via live_mask


# ---------------------------------------------------------------------------
# expression admission + structural keys
# ---------------------------------------------------------------------------

# operators a program body may hold: every operator the evaluator computes
# but ||, which builds one string per row on the host
_TRACEABLE_BINOPS = {
    lp.BinOp.AND, lp.BinOp.OR, lp.BinOp.EQ, lp.BinOp.NEQ, lp.BinOp.LT,
    lp.BinOp.LTE, lp.BinOp.GT, lp.BinOp.GTE, lp.BinOp.ADD, lp.BinOp.SUB,
    lp.BinOp.MUL, lp.BinOp.DIV, lp.BinOp.MOD, lp.BinOp.LIKE,
    lp.BinOp.NOT_LIKE, lp.BinOp.ILIKE, lp.BinOp.NOT_ILIKE,
    lp.BinOp.TS_MATCH,
} | lp._REGEX_OPS | lp._JSON_OPS


# subquery expressions: their plans run before the program (_SegCtx.sub_exprs)
_SUBQUERY_EXPRS = (lp.ScalarSubqueryExpr, lp.InSubqueryExpr, lp.ExistsExpr,
                   lp.QuantifiedCmpExpr, lp.CorrelatedLookupExpr)

_JSON_PATH_FNS = (lp.ScalarFn.JSON_EXTRACT_PATH,
                  lp.ScalarFn.JSON_EXTRACT_PATH_TEXT)


def _expr_traceable(e: lp.LogicalExpr) -> bool:
    """Static check that a program body can evaluate the expression: the
    node kinds the port's evaluator computes, less what the JAX package's
    rule keeps out of a program because it needs host work per row or per
    call: UDF calls, CONCAT and ||, a number cast to a string, a JSON key
    or path that is not a literal, @@ against a query that is not a
    literal, and the LIST functions. (On CUDA the pipeline also keeps out
    whatever builds a host table: `expr_eval.builds_host_table`.)"""
    bad = []

    def visit(x):
        if isinstance(x, lp.BinaryExpr):
            if x.op not in _TRACEABLE_BINOPS:
                bad.append(x)
            elif x.op in lp._JSON_OPS and static_json_key(x.right) is None:
                bad.append(x)
            elif x.op is lp.BinOp.TS_MATCH:
                r = x.right
                if isinstance(r, lp.ScalarFnExpr) \
                        and r.func is lp.ScalarFn.TO_TSQUERY and r.args:
                    r = r.args[0]
                if not isinstance(r, lp.Literal):
                    bad.append(x)
        elif isinstance(x, lp.ScalarFnExpr):
            if x.func is lp.ScalarFn.CONCAT or x.func in LIST_FNS:
                bad.append(x)
            elif x.func in _JSON_PATH_FNS and any(
                    static_json_key(a) is None for a in x.args[1:]):
                bad.append(x)
        elif isinstance(x, lp.CastExpr):
            # CAST(NULL AS VARCHAR), a grouping set's padding, makes no
            # string
            if x.target.is_dictionary and not x.expr.dtype.is_dictionary \
                    and x.expr.dtype.kind is not TypeKind.NULL:
                bad.append(x)
        elif not isinstance(x, (lp.ColumnRef, lp.Literal, lp.IntervalLiteral,
                                lp.AliasExpr, lp.UnaryExpr, lp.IsNullExpr,
                                lp.CaseExpr, lp.InListExpr, lp.WindowExpr)
                            + _SUBQUERY_EXPRS):
            bad.append(x)  # a UDF call among them

    lp.walk_exprs(e, visit)
    return not bad


# functions whose arguments after the first are read on the host while the
# program is built (expr_eval's _static_num, _literal_str, static_json_key)
_HOST_READ_ARGS = {
    lp.ScalarFn.SUBSTRING, lp.ScalarFn.ROUND, lp.ScalarFn.TRUNC,
    lp.ScalarFn.LEFT, lp.ScalarFn.RIGHT, lp.ScalarFn.LPAD, lp.ScalarFn.RPAD,
    lp.ScalarFn.SPLIT_PART, lp.ScalarFn.REPEAT,
} | set(_JSON_PATH_FNS)


def _static_operands(e: lp.LogicalExpr):
    """The operands of `e` that a program bakes in (the JAX package's
    `_mark_static_literals`): ROUND's and TRUNC's digits, the lengths of
    LEFT, RIGHT, LPAD, RPAD and REPEAT, SUBSTRING's start and length,
    SPLIT_PART's field, the JSON keys and paths, and a window function's
    NTILE n, LAG/LEAD offset and NTH_VALUE n. They key the program by
    value, so `ROUND(x, 2)` and `ROUND(x, 3)` are two programs; any other
    number literal is a program input."""
    if isinstance(e, lp.WindowExpr):
        return W.static_args(e)
    if isinstance(e, lp.ScalarFnExpr) and e.func in _HOST_READ_ARGS:
        return e.args[1:]
    if isinstance(e, lp.BinaryExpr) and e.op in lp._JSON_OPS:
        return [e.right]
    return []


def _dyn_int(e, value: int, ctx):
    """Key `e` as an int program input holding `value`."""
    ctx.dyn_vals.append(("i", int(value)))
    ctx.dyn_exprs.append(e)
    return ("dynlit", "i")


def _expr_key(e: lp.LogicalExpr, ctx=None):
    """Structural key: equal keys => identical computation over identical
    input planes. (Unlike LogicalExpr.name(), aliases do not hide the inner
    expression and column references key on their resolved index.)

    With a _SegCtx, numeric/bool literals key as ("dynlit", kind) and their
    VALUES are collected into ctx.dyn_vals — they become program inputs, so
    one program serves every value (`age > 25` and `age > 30`). A date
    literal (`d < '1995-03-15'`, `DATE '1995-01-01'`) is parsed here and
    becomes an int input the same way: a replay with another date reads the
    new value.

    With a _SegCtx, a subquery expression keys only its outer computation
    and is collected into ctx.sub_exprs: its plan runs before the program
    and its result batch is a program input (its capacity and types key the
    program through the entry key's sub_sigs)."""
    if isinstance(e, lp.ColumnRef):
        return ("col", e.index, str(e.dtype))
    if isinstance(e, lp.Literal):
        v = e.value.value
        if (
            ctx is not None and v is not None and not isinstance(v, str)
            and isinstance(v, (bool, int, float))
            and not e.value.dtype.is_dictionary
        ):
            if isinstance(v, bool):
                tag, sv = "b", v
            elif isinstance(v, int) and not e.value.dtype.is_float:
                tag, sv = "i", int(v)
            else:
                tag, sv = "f", float(v)
            ctx.dyn_vals.append((tag, sv))
            ctx.dyn_exprs.append(e)
            return ("dynlit", tag)
        return ("lit", str(e.value.dtype), repr(v))
    if isinstance(e, lp.IntervalLiteral):
        return ("ival", e.months, e.days, e.micros)
    if isinstance(e, lp.AliasExpr):
        # alias names land in the output schema -> they are part of the key
        return ("as", e.alias, _expr_key(e.expr, ctx))
    # the date literal this node parses (the literal or the cast), if any
    node, value = (ctx is not None and temporal_literal(e)) or (None, None)
    static = {id(a) for a in _static_operands(e)}
    if isinstance(e, lp.BinaryExpr):
        return ("bin", e.op.value, *(
            _dyn_int(x, value, ctx) if x is node
            else _expr_key(x, None if id(x) in static else ctx)
            for x in (e.left, e.right)))
    if isinstance(e, lp.UnaryExpr):
        return ("un", e.op.value, _expr_key(e.expr, ctx))
    if isinstance(e, lp.CastExpr):
        return ("cast", str(e.target), _dyn_int(e, value, ctx) if node is e
                else _expr_key(e.expr, ctx))
    if isinstance(e, lp.ScalarFnExpr):
        return ("fn", e.func.value, tuple(
            _expr_key(a, None if id(a) in static else ctx) for a in e.args))
    if isinstance(e, lp.CaseExpr):
        return (
            "case",
            tuple((_expr_key(c, ctx), _expr_key(v, ctx))
                  for c, v in e.branches),
            None if e.else_expr is None else _expr_key(e.else_expr, ctx),
        )
    if isinstance(e, lp.InListExpr):
        return ("inlist", e.negated, _expr_key(e.expr, ctx),
                tuple(_expr_key(i, ctx) for i in e.items))
    if isinstance(e, lp.IsNullExpr):
        return ("isnull", e.negated, _expr_key(e.expr, ctx))
    if isinstance(e, lp.AggregateExpr):
        return (
            "agg", e.func.value, e.distinct,
            None if e.expr is None else _expr_key(e.expr, ctx),
        )
    if isinstance(e, lp.WindowExpr):
        return (
            "win", e.func.value,
            tuple(_expr_key(a, None if id(a) in static else ctx)
                  for a in e.args),
            tuple(_expr_key(p, ctx) for p in e.partition_by),
            tuple(_sort_key_key(k, ctx) for k in e.order_by),
            repr(e.frame),
        )
    if ctx is not None and isinstance(e, _SUBQUERY_EXPRS):
        if isinstance(e, lp.ScalarSubqueryExpr):
            key = ("ssub", str(e.dtype))
        elif isinstance(e, lp.InSubqueryExpr):
            key = ("insub", e.negated, _expr_key(e.expr, ctx))
        elif isinstance(e, lp.ExistsExpr):
            key = ("exists", e.negated)
        elif isinstance(e, lp.QuantifiedCmpExpr):
            key = ("qcmp", e.op.value, e.is_any, _expr_key(e.expr, ctx))
        else:
            key = ("corr", e.mode, e.negated,
                   None if e.miss_value is None else repr(e.miss_value.value),
                   tuple(_expr_key(k, ctx) for k in e.outer_keys))
        ctx.sub_exprs.append(e)
        return key
    raise _Unsupported(f"expr {type(e).__name__}")


_NULL_ORIGIN = ("null",)


def _dict_origin(plan, i: int):
    """Where column i of `plan` takes its dictionary from, known from the
    plan alone: ("scan", source, column) for a stored table's column passed
    on unchanged (through renames, filters, sorts, limits, DISTINCT, group
    keys and UNION ALL), _NULL_ORIGIN for a NULL (a grouping set's padding,
    which holds no value), else None."""
    while True:
        if isinstance(plan, pp.PScan):
            col = i if plan.projection is None else plan.projection[i]
            return ("scan", id(plan.source), col)
        if isinstance(plan, pp.PProjection):
            e = plan.exprs[i]
            # a string or a NULL cast to a string keeps its dictionary
            while isinstance(e, lp.AliasExpr) or (
                    isinstance(e, lp.CastExpr)
                    and (e.expr.dtype.is_dictionary
                         or e.expr.dtype.kind is TypeKind.NULL)):
                e = e.expr
            if isinstance(e, lp.Literal) and e.value.value is None:
                return _NULL_ORIGIN
            if not isinstance(e, lp.ColumnRef):
                return None
            plan, i = plan.input, e.index
        elif isinstance(plan, pp.PHashAggregate):
            if i >= len(plan.group_exprs) \
                    or not isinstance(plan.group_exprs[i], lp.ColumnRef):
                return None
            plan, i = plan.input, plan.group_exprs[i].index
        elif isinstance(plan, pp.PSetOp):
            return _union_origin(plan.kind, _dict_origin(plan.left, i),
                                 _dict_origin(plan.right, i))
        elif _passes_rows(plan):
            plan = plan.input
        else:
            return None


def _union_origin(kind, a, b):
    """The origin of a set operation's column from its sides' (None when
    the sides' dictionaries would have to merge)."""
    if a is None or b is None:
        return None
    if a == b:
        return a
    if kind in (lp.SetOpKind.UNION, lp.SetOpKind.UNION_ALL) \
            and _NULL_ORIGIN in (a, b):
        return b if a == _NULL_ORIGIN else a
    return None


def _setop_shares_dicts(plan: pp.PSetOp) -> bool:
    """True when every string column of the set operation takes both
    sides' values from one dictionary, or one side holds only NULLs (a
    CUBE's or ROLLUP's UNION ALL of aggregates over one table): no host
    table merges them (`_shared_dicts`)."""
    return all(
        _union_origin(plan.kind, _dict_origin(plan.left, i),
                      _dict_origin(plan.right, i)) is not None
        for i, f in enumerate(plan.left.schema())
        if f.data_type.is_dictionary
        or plan.right.schema().field(i).data_type.is_dictionary)


def _shared_dicts(kind, lv: Val, rv: Val):
    """The two sides of a set operation's string column on one dictionary
    without a host table, when one serves both: the same dictionary, or
    (UNION [ALL]) a side that holds only NULLs takes the other's. Else
    None."""
    ld, rd = lv.dictionary, rv.dictionary
    if ld is rd:
        return lv, rv
    if kind not in (lp.SetOpKind.UNION, lp.SetOpKind.UNION_ALL):
        return None
    if rd is None or len(rd) == 0:
        return lv, Val(rv.data.to(lv.data.dtype), rv.validity, rv.dtype, ld)
    if ld is None or len(ld) == 0:
        return Val(lv.data.to(rv.data.dtype), lv.validity, lv.dtype, rd), rv
    return None


def _passes_rows(node) -> bool:
    """A node whose output columns are its input's (a subset of its rows, a
    new order, or new names): key multiplicities seen below hold above."""
    return isinstance(node, (pp.PFilter, pp.PSort, pp.PLimit,
                             pp.PDistinct)) or (
        isinstance(node, pp.PSubquery) and not node.shared)


def _sort_key_key(k: lp.SortKey, ctx=None):
    return (_expr_key(k.expr, ctx), k.asc, k.resolved_nulls_first())


# single-input nodes a program body traces: node type -> _trace_<name>
_OPERATORS = {pp.PFilter: "filter", pp.PProjection: "projection",
              pp.PSort: "sort", pp.PLimit: "limit",
              pp.PHashAggregate: "aggregate", pp.PDistinct: "distinct",
              pp.PWindow: "window"}

_DYN_DTYPES = {"b": torch.bool, "i": torch.int64, "f": torch.float64}

# aggregate functions a program body computes (the eager executor's set)
_AGG_FUNCS = {lp.AggFunc.COUNT, lp.AggFunc.SUM, lp.AggFunc.AVG,
              lp.AggFunc.MIN, lp.AggFunc.MAX}
_KERNEL_FUNCS = (lp.AggFunc.SUM, lp.AggFunc.COUNT, lp.AggFunc.AVG)


# ---------------------------------------------------------------------------
# the pipeline compiler
# ---------------------------------------------------------------------------


class _SegCtx:
    """Per-analysis context: joins forced to eager boundaries, join
    duplication checks, dynamic-literal and subquery collection."""

    __slots__ = ("forced", "checks", "dyn_vals", "dyn_exprs", "sub_exprs")

    def __init__(self, forced):
        self.forced = forced
        self.checks = []  # (join node, left provenance, right provenance)
        self.dyn_vals = []   # (tag, python value), traversal order
        self.dyn_exprs = []  # the literal exprs (kept alive via entry.plan)
        self.sub_exprs = []  # subquery exprs, traversal order: their plans
        # run before the program, their batches are program inputs


class CompiledPipeline:
    def __init__(self, executor):
        self.executor = executor  # eager QueryExecutor (fallback + leaves)
        self._cache = {}  # plan key -> _Entry
        self._eager_bodies = set()  # structural keys known to fail tracing
        # the small-table gather gate, read once per session (JAX reads it
        # at trace time, outside its cache key)
        self.mxu_gather = os.environ.get("QE_MXU_GATHER") == "1"
        # on CUDA, programs are captured into graphs
        self._graphs = executor.device.type == "cuda"
        self.stats = {"compiles": 0, "hits": 0, "fallbacks": 0,
                      "joins_inlined": 0, "joins_demoted": 0,
                      # count->emit: sizes read from count programs (joins
                      # and aggregates, per query); emit programs that
                      # reuse the count program's join sort or grouping,
                      # and GROUP BY keys pruned as dependent, per compile
                      "joins_counted": 0, "join_sorts_reused": 0,
                      "group_sorts_reused": 0, "fd_pruned_keys": 0,
                      "captures": 0, "replays": 0,
                      # window sorts made and OVER specs seen, per compile
                      "window_sorts": 0, "window_specs": 0,
                      # host-clock ms in the eager subtrees run as leaves
                      # (the outermost ones) and in captures outside them
                      "leaf_ms": 0.0, "capture_ms": 0.0}
        self.leaf_kinds = collections.Counter()  # eager leaves by node type
        self._leaf_depth = 0
        # state of the body a thread runs (a mesh program runs one body per
        # shard, each in a thread of its own, over this pipeline)
        self._tls = threading.local()

    # while a body runs, per thread: a program's first run (per-compile
    # stats count once), bodies whose stats another thread counts (a mesh
    # program's other shards, its later runs), the body's leaf node ids
    # (`_fd_dependent_keys`), and counted node id -> the planes its count
    # program handed over
    @property
    def _compiling(self) -> bool:
        return getattr(self._tls, "compiling", False)

    @_compiling.setter
    def _compiling(self, value: bool) -> None:
        self._tls.compiling = value

    @property
    def _muted(self) -> bool:
        return getattr(self._tls, "muted", False)

    @_muted.setter
    def _muted(self, value: bool) -> None:
        self._tls.muted = value

    @property
    def _leaf_ids(self) -> frozenset:
        return getattr(self._tls, "leaf_ids", frozenset())

    @_leaf_ids.setter
    def _leaf_ids(self, value: frozenset) -> None:
        self._tls.leaf_ids = value

    @property
    def _xfer_by_node(self) -> dict:
        return getattr(self._tls, "xfer_by_node", {})

    @_xfer_by_node.setter
    def _xfer_by_node(self, value: dict) -> None:
        self._tls.xfer_by_node = value

    # ---- entry -----------------------------------------------------------
    def try_execute(self, plan: pp.PhysicalPlan) -> Optional[ColumnBatch]:
        """Returns the result batch, or None to run the eager path."""
        host = self.executor._host_list
        forced: set = set()
        subs_by_plan = {}  # a subquery's batch, kept across demotions
        while True:  # a join whose count fails demotes to an eager leaf
            ctx = _SegCtx(forced)
            try:
                key_body, leaf_nodes, n_compute = self._plan_key(plan, ctx)
            except _Unsupported:
                return None
            if n_compute == 0:
                return None  # pure scan/limit/rename — eager is already cheap
            if key_body in self._eager_bodies:
                self.stats["fallbacks"] += 1
                return None

            # materialize leaves (table scans + eager subtrees)
            leaves = [self._materialize_leaf(n) for n in leaf_nodes]
            for b in leaves:
                ensure_bounds(b, host)  # one read per batch, cached
            batch_by_node = dict(zip(map(id, leaf_nodes), leaves))
            res = self._resolve_checks(ctx, leaves, batch_by_node)

            # subquery plans run now, before any program runs or is
            # captured; their result batches are program inputs after the
            # leaves
            for x in ctx.sub_exprs:
                if id(x.plan) not in subs_by_plan:
                    subs_by_plan[id(x.plan)] = self._materialize_leaf(
                        x.plan, "subplan")
            subs = [subs_by_plan[id(x.plan)] for x in ctx.sub_exprs]
            dyn_vals = tuple(ctx.dyn_vals)
            sigs = (key_body, tuple(self._leaf_sig(b) for b in leaves),
                    tuple(self._leaf_sig(b) for b in subs),
                    tuple(tag for tag, _ in dyn_vals))
            xfers = self._count_pending(plan, ctx, res, leaves, leaf_nodes,
                                        subs, dyn_vals, sigs)
            if xfers is not None:
                break

        sides = tuple(res[id(j)] for j, _, _ in ctx.checks)
        xfer_ords = tuple(sorted(xfers))
        xfer = tuple(xfers[o] for o in xfer_ords)
        key = sigs + (sides, xfer_ords)
        entry = self._cache.get(key)
        inputs = leaves + subs

        if entry is None:
            entry = self._new_entry(plan, ctx, leaves, leaf_nodes, res, subs)
            entry.xfer_ords = xfer_ords
            try:
                out = self._first_run(entry, inputs, dyn_vals, xfer)
            except _TRACE_ERRORS:
                self._eager_bodies.add(key_body)
                self.stats["fallbacks"] += 1
                return None
            self._cache[key] = entry
            self.stats["compiles"] += 1
        else:
            self.stats["hits"] += 1
            out = self._rerun(entry, inputs, dyn_vals, xfer)

        datas, valids, sel, count = out
        count = self.executor._host_int(count)
        meta = entry.meta
        if meta["dense"]:
            if out is entry.outputs:
                # the next replay overwrites the graph's output tensors
                datas = [d.clone() for d in datas]
                valids = [v.clone() for v in valids]
            cols = [
                Column(d, v, dt, dic)
                for d, v, dt, dic in zip(
                    datas, valids, meta["dtypes"], meta["dicts"]
                )
            ]
            return ColumnBatch(meta["schema"], cols, count)
        # surviving rows are scattered: one compaction (fresh tensors)
        idx = K.compaction_indices(sel, sel, padded_capacity(count))
        cd, cv = K.gather_columns_packed(
            list(datas), list(valids), [None] * len(datas), idx
        )
        cols = [
            Column(d, v, dt, dic)
            for d, v, dt, dic in zip(cd, cv, meta["dtypes"], meta["dicts"])
        ]
        return ColumnBatch(meta["schema"], cols, count)

    def _resolve_checks(self, ctx, leaves, batch_by_node):
        """Each checked join's resolution: ("R"|"L", bucket) for a side
        whose key multiplicity is statically bounded (1 = unique, the FK
        paths; 2-16, a static emit), ("C", None) for a join to count, and
        ("C", None) for every aggregate that counts its groups."""
        res = {}
        for jnode, lprov, rprov in ctx.checks:
            if lprov == "AGG":
                res[id(jnode)] = ("C", None)
                continue
            dr = self._prov_max_dup(rprov, batch_by_node, res)
            # a unique right side wins every tie: the left side's stat (a
            # sort of its key plane and a host read) is not needed
            dl = None if dr == 1 else self._prov_max_dup(
                lprov, batch_by_node, res)
            side = None
            # prefer the right (build) side on ties; bucket to pow2 so data
            # drift within a bucket reuses the program
            if dr is not None and (dl is None or dr <= dl):
                side = ("R", _dup_bucket(dr))
            elif dl is not None:
                side = ("L", _dup_bucket(dl))
            # the static emit is the probe capacity times the bucket: count
            # rather than allocate past _MAX_EMIT rows. The FK path emits
            # nothing (its rows are the probe side's own), so a unique side
            # taking it is left alone; the JAX package counts it too, and
            # then demotes the join of a table past 2^26 rows
            if side is not None and side[1] is not None and leaves \
                    and not _fk_path(jnode.join_type, side) \
                    and max(b.capacity for b in leaves) * side[1] > _MAX_EMIT:
                side = (side[0], None)
            res[id(jnode)] = (("C", None) if side is None or side[1] is None
                              else side)
        return res

    def _count_pending(self, plan, ctx, res, leaves, leaf_nodes, subs,
                       dyn_vals, sigs):
        """The count->emit capacity sync. For each check still ("C", None),
        first in trace order: a cached COUNT program returns its output
        size, the host reads it (one sync), and the check resolves to ("E",
        the pow2 bucket), so the emit program is static. Returns {check
        ordinal: the planes the count program hands the emit program}, or
        None after demoting a join to an eager leaf (its count program
        failed, or its size passes _MAX_EMIT)."""
        inputs = leaves + subs
        xfers = {}
        while True:
            pending = [j for j, _, _ in ctx.checks
                       if res[id(j)] == ("C", None)]
            if not pending:
                return xfers
            ckey = sigs + (tuple(res[id(j)] for j, _, _ in ctx.checks),
                           "count")
            centry = self._cache.get(ckey)
            out = None
            if centry is None:
                centry = self._new_entry(plan, ctx, leaves, leaf_nodes,
                                         dict(res), subs)
                centry.counts = True
                try:
                    out = self._first_run(centry, inputs, dyn_vals)
                except _TRACE_ERRORS:
                    out = None
                if out is not None:
                    self._cache[ckey] = centry
                    self.stats["compiles"] += 1
            else:
                self.stats["hits"] += 1
                out = self._rerun(centry, inputs, dyn_vals)
            if out is None:
                jnode, out_rows = pending[0], None
            else:
                count, extras = out
                jnode = ctx.checks[centry.ordinal][0]
                out_rows = self.executor._host_int(count)
            bucket = padded_capacity(out_rows or 0)
            if out_rows is None or bucket > _MAX_EMIT:
                ctx.forced.add(id(jnode))
                self.stats["joins_demoted"] += 1
                return None
            res[id(jnode)] = ("E", bucket)
            if extras:
                xfers[centry.ordinal] = extras
            self.stats["joins_counted"] += 1

    def _new_entry(self, plan, ctx, leaves, leaf_nodes, res, subs):
        entry = _Entry(plan, leaves)
        entry.leaf_ids = frozenset(map(id, leaf_nodes))
        entry.res = res
        entry.checks = [j for j, _, _ in ctx.checks]
        entry.dyn_exprs = list(ctx.dyn_exprs)
        entry.sub_exprs = list(ctx.sub_exprs)
        entry.subs = subs
        entry.leaf_bounds = [
            [None if (bb := _bucket_bounds(_col_bounds(c))) is None
             or bb == ("big",) else bb for c in b.columns]
            for b in leaves
        ]
        return entry

    def drop_entries_reading(self, sources) -> int:
        """Drop the cached programs whose plan reads one of `sources` (the
        tables a DML or DDL statement or a ROLLBACK replaced). Such an
        entry holds the table's old batch (`leaves`), the planes its graph
        read and its eager leaves' batches; a new version of the table keys
        a new entry, so without this every refresh would leave one table's
        worth of planes reachable. Returns the number dropped."""
        ids = {id(s) for s in sources}
        dead = [k for k, e in self._cache.items()
                if ids & _sources_read(e.plan, e.sub_exprs)]
        for k in dead:
            del self._cache[k]
        return len(dead)

    # ---- running a program -------------------------------------------------
    def _body(self, entry, planes, n_bufs, dyn_bufs, xfer=()):
        """The program: the plan segment over the input planes (the leaves',
        then the subquery batches'), row-count tensors, literal tensors and
        the planes count programs handed over (`xfer`, one tuple per
        counted check of `entry.xfer_ords`). Reads nothing from the device.

        An emit program returns (datas, valids, sel, row count); a count
        program (`entry.counts`) stops at the first node still to count
        and returns (its output size, the planes it hands over)."""
        batches = entry.leaves + entry.subs
        bounds = entry.leaf_bounds + [[None] * len(b.columns)
                                      for b in entry.subs]
        tables = [
            _TTable(
                schema=b.schema,
                cols=[
                    Column(d, v, c.dtype, c.dictionary)
                    for (d, v), c in zip(pl, b.columns)
                ],
                sel=K.live_mask(b.capacity, n),
                capacity=b.capacity,
                dense=True,
                bounds=list(bd),
            )
            for pl, n, b, bd in zip(planes, n_bufs, batches, bounds)
        ]
        n_leaves = len(entry.leaves)
        ev = self.executor.evaluator
        ev._dyn_literals = {
            id(e): v for e, v in zip(entry.dyn_exprs, dyn_bufs)
        }
        ev._subplans = {
            id(x.plan): _ShimBatch(t)
            for x, t in zip(entry.sub_exprs, tables[n_leaves:])
        }
        self._leaf_ids = entry.leaf_ids
        self._xfer_by_node = {id(entry.checks[o]): x
                              for o, x in zip(entry.xfer_ords, xfer)}
        try:
            t = self._trace(entry.plan, iter(tables[:n_leaves]),
                            entry.leaf_ids, entry.res)
        except _CountReady as e:
            # caught here, inside the body: a capture around the body ends
            # normally, its outputs the count and the handed-over planes
            ordinal = next((i for i, j in enumerate(entry.checks)
                            if j is e.node), None)
            if not entry.counts or ordinal is None:
                raise _Unsupported("a count outside a count program")
            entry.ordinal = ordinal
            count = e.count
            if not isinstance(count, torch.Tensor):
                count = torch.full((), int(count), dtype=torch.int64,
                                   device=self.executor.device)
            return count.to(torch.int64), tuple(e.extras)
        finally:
            ev._dyn_literals = None
            ev._subplans = None
            self._leaf_ids = frozenset()
            self._xfer_by_node = {}
        if entry.counts:
            raise _Unsupported("no counted node reached in the trace")
        if not entry.meta:
            entry.meta.update(
                schema=t.schema,
                dtypes=[c.dtype for c in t.cols],
                dicts=[c.dictionary for c in t.cols],
                dense=t.dense,
            )
        count = K.filter_count(t.sel, t.sel)
        return ([c.data for c in t.cols], [c.validity for c in t.cols],
                t.sel, count)

    def _inputs(self, batches, dyn_vals):
        dev = self.executor.device
        planes = [[(c.data, c.validity) for c in b.columns] for b in batches]
        n_bufs = [torch.tensor(b.num_rows, dtype=torch.int64, device=dev)
                  for b in batches]
        dyn_bufs = [torch.tensor(v, dtype=_DYN_DTYPES[tag], device=dev)
                    for tag, v in dyn_vals]
        return planes, n_bufs, dyn_bufs

    def _first_run(self, entry, batches, dyn_vals, xfer=()):
        """Run the body once eagerly; on CUDA, then capture it. A count
        program's first run returns the graph's own output tensors (filled
        with the eager run's values), so the emit program that reads them
        is captured over the addresses later replays write."""
        planes, n_bufs, dyn_bufs = self._inputs(batches, dyn_vals)
        self._compiling = True
        try:
            out = self._body(entry, planes, n_bufs, dyn_bufs, xfer)
        finally:
            self._compiling = False
        if self._graphs:
            self._capture(entry, planes, n_bufs, dyn_bufs, xfer)
            if entry.counts and entry.outputs is not None:
                for dst, src in zip(_flat(entry.outputs), _flat(out)):
                    dst.copy_(src)
                return entry.outputs
        return out

    def _rerun(self, entry, batches, dyn_vals, xfer=()):
        if entry.graph is None:  # CPU: run the body again
            return self._body(entry, *self._inputs(batches, dyn_vals), xfer)
        planes = [[(c.data, c.validity) for c in b.columns] for b in batches]
        if _ptrs(planes, xfer) != entry.ptrs:
            # an input's planes changed (a table registered anew, an eager
            # leaf's or a subquery's new batch, a count program captured
            # anew): the graph would read the old addresses, so capture
            # over the new ones
            self._capture(entry, planes, entry.n_bufs, entry.dyn_bufs, xfer)
        for buf, b in zip(entry.n_bufs, batches):
            buf.fill_(b.num_rows)
        for buf, (_, v) in zip(entry.dyn_bufs, dyn_vals):
            buf.fill_(v)
        entry.graph.replay()
        self.stats["replays"] += 1
        return entry.outputs

    def _capture(self, entry, planes, n_bufs, dyn_bufs, xfer=()):
        """Capture the body into a CUDA graph over these inputs. The entry
        keeps the input tensors alive: the graph reads their addresses."""
        t0 = time.perf_counter()
        # Thread-local mode: the CUDA calls of another thread (another
        # Session's query) do not break this capture; this thread's own
        # unsafe calls still do. Threads that share this Session hold its
        # lock. The captures of all Sessions take turns: torch.cuda.graph
        # synchronizes the device before it captures, which would break a
        # capture under way in another thread, and captures on one stream.
        with _CAPTURE_LOCK:
            entry.graph = entry.outputs = None  # free the old graph's pool
            graph = torch.cuda.CUDAGraph()
            # A cyclic collection inside the capture may free another CUDA
            # graph (one an unreachable cycle holds, e.g. a dropped
            # Session's); CUDA refuses that while a stream captures, and the
            # capture is lost. So the collector waits until the capture ends.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    outputs = self._body(entry, planes, n_bufs, dyn_bufs,
                                         xfer)
            finally:
                if collecting:
                    gc.enable()
        if self._leaf_depth == 0:
            self.stats["capture_ms"] += (time.perf_counter() - t0) * 1e3
        entry.graph = graph
        entry.outputs = outputs
        entry.planes = planes
        entry.xfer = xfer
        entry.ptrs = _ptrs(planes, xfer)
        entry.n_bufs = n_bufs
        entry.dyn_bufs = dyn_bufs
        self.stats["captures"] += 1

    # ---- segment analysis --------------------------------------------------
    def _traceable(self, e: lp.LogicalExpr) -> bool:
        # a graph cannot capture a host table's copy to the device
        return _expr_traceable(e) and not (self._graphs
                                           and builds_host_table(e))

    def _child(self, plan, ctx):
        """Key a child subtree; an unsupported child becomes a leaf boundary
        (executed eagerly) instead of abandoning the segment above it."""
        cp_checks, cp_dyn = len(ctx.checks), len(ctx.dyn_vals)
        cp_sub = len(ctx.sub_exprs)
        try:
            return self._plan_key(plan, ctx)
        except _Unsupported:
            # drop state collected by the failed subtree: phantom dyn
            # literals or subplans would misalign against the key's slots
            del ctx.checks[cp_checks:]
            del ctx.dyn_vals[cp_dyn:]
            del ctx.dyn_exprs[cp_dyn:]
            del ctx.sub_exprs[cp_sub:]
            return ("leaf",), [plan], 0

    def _plan_key(self, plan, ctx):
        """Validate + build the structural cache key; returns (body, leaf
        plan nodes in trace order, #compute nodes). Raises _Unsupported when
        this node cannot live inside a compiled segment."""
        if isinstance(plan, pp.PScan):
            return ("leaf",), [plan], 0
        if id(plan) in ctx.forced:
            raise _Unsupported("forced boundary")
        if isinstance(plan, pp.PHashJoin):
            return self._plan_key_join(plan, ctx)
        if isinstance(plan, pp.PFilter):
            if not self._traceable(plan.predicate):
                raise _Unsupported("filter predicate")
            body, leaves, n = self._child(plan.input, ctx)
            return (
                ("filter", _expr_key(plan.predicate, ctx), body),
                leaves, n + 1,
            )
        if isinstance(plan, pp.PProjection):
            if not all(self._traceable(e) for e in plan.exprs):
                raise _Unsupported("projection exprs")
            body, leaves, n = self._child(plan.input, ctx)
            trivial = all(
                isinstance(e, lp.ColumnRef)
                or (isinstance(e, lp.AliasExpr)
                    and isinstance(e.expr, lp.ColumnRef))
                for e in plan.exprs
            )
            return (
                ("proj", tuple(_expr_key(e, ctx) for e in plan.exprs), body),
                leaves,
                n if trivial else n + 1,
            )
        if isinstance(plan, pp.PSort):
            if not all(self._traceable(k.expr) for k in plan.keys):
                raise _Unsupported("sort keys")
            body, leaves, n = self._child(plan.input, ctx)
            return (
                ("sort", tuple(_sort_key_key(k, ctx) for k in plan.keys),
                 body),
                leaves, n + 1,
            )
        if isinstance(plan, pp.PLimit):
            body, leaves, n = self._child(plan.input, ctx)
            return ("limit", plan.skip, plan.fetch, body), leaves, n
        if isinstance(plan, pp.PHashAggregate):
            if plan.mode != "single":
                raise _Unsupported("distributed aggregate mode")
            if any(a.func not in _AGG_FUNCS for a in plan.agg_exprs):
                raise _Unsupported("aggregate function")
            exprs = list(plan.group_exprs) + [
                a.expr for a in plan.agg_exprs if a.expr is not None
            ]
            if not all(self._traceable(e) for e in exprs):
                raise _Unsupported("aggregate exprs")
            body, leaves, n = self._child(plan.input, ctx)
            # group-space count->emit: keys with no static range would run
            # every plane above at row capacity; a count program returns ng
            # once and the emit program aggregates at padded(ng)
            if plan.group_exprs and self._agg_needs_count(plan):
                ctx.checks.append((plan, "AGG", None))
            return (
                (
                    "agg",
                    tuple(_expr_key(g, ctx) for g in plan.group_exprs),
                    tuple(
                        (a.func.value, a.distinct,
                         None if a.expr is None else _expr_key(a.expr, ctx))
                        for a in plan.agg_exprs
                    ),
                    tuple(plan.schema().names()),
                    body,
                ),
                leaves, n + 1,
            )
        if isinstance(plan, pp.PSubquery):
            if plan.shared:
                # a WITH query referenced more than once: a leaf boundary,
                # so the executor materializes it ONCE and every reference
                # (this segment, others, subquery plans) reads that batch
                raise _Unsupported("shared CTE (materialized once)")
            # a derived table: a pass-through node that renames its child
            body, leaves, n = self._child(plan.input, ctx)
            return ("subq", tuple(plan.out_schema.names()), body), leaves, n
        if isinstance(plan, pp.PDistinct):
            on = plan.on
            if on is not None and not all(self._traceable(e) for e in on):
                raise _Unsupported("distinct exprs")
            body, leaves, n = self._child(plan.input, ctx)
            okey = None if on is None else tuple(_expr_key(e, ctx)
                                                 for e in on)
            return ("distinct", okey, body), leaves, n + 1
        if isinstance(plan, pp.PWindow):
            if not all(self._traceable(w) for w in plan.window_exprs):
                raise _Unsupported("window exprs")
            body, leaves, n = self._child(plan.input, ctx)
            return (
                ("window", tuple(_expr_key(w, ctx) for w in plan.window_exprs),
                 tuple(plan.names), body),
                leaves, n + 1,
            )
        if isinstance(plan, pp.PSetOp):
            if self._graphs and not _setop_shares_dicts(plan):
                # merging two dictionaries builds a host table
                raise _Unsupported("string set operation")
            lbody, lleaves, ln = self._child(plan.left, ctx)
            rbody, rleaves, rn = self._child(plan.right, ctx)
            return (("setop", plan.kind.value, lbody, rbody),
                    lleaves + rleaves, ln + rn + 1)
        # anything else: an eager leaf boundary (CROSS join, VALUES, ...)
        raise _Unsupported(type(plan).__name__)

    @staticmethod
    def _agg_needs_count(plan: pp.PHashAggregate) -> bool:
        """A static proxy for "this aggregate would group at S = capacity":
        some group key is not a bare integer, bool or string column (whose
        stats or dictionary size give a static range). A needless check
        costs one cached count program; a missed one keeps S = capacity."""
        for g in plan.group_exprs:
            e = g
            while isinstance(e, lp.AliasExpr):
                e = e.expr
            if not isinstance(e, lp.ColumnRef):
                return True
            if e.dtype.is_dictionary:
                continue
            dt = e.dtype.device_dtype
            if not (np.issubdtype(dt, np.integer) or dt == np.bool_):
                return True
        return False

    def _plan_key_join(self, plan: pp.PHashJoin, ctx):
        """An equi-join (INNER, LEFT, RIGHT or FULL) joins the segment when
        its key tuple has a known provenance on one side: a GROUP BY above
        the key (structural) or leaf columns whose cached multiplicity stat
        try_execute reads (valid under the filters/sorts/limits between
        leaf and join — subsets only shrink multiplicities). try_execute
        resolves it to a static emit or to the count->emit sync."""
        if plan.join_type is lp.JoinType.CROSS or not plan.key_pairs:
            raise _Unsupported("cross join")
        for le, re_ in plan.key_pairs:
            if not (self._traceable(le) and self._traceable(re_)) or (
                self._graphs
                and (le.dtype.is_dictionary or re_.dtype.is_dictionary)
            ):
                raise _Unsupported("join key exprs")
        if plan.residual is not None and not self._traceable(plan.residual):
            raise _Unsupported("join residual")
        lprov = self._unique_prov_multi(
            plan.left, [le for le, _ in plan.key_pairs], ctx
        )
        rprov = self._unique_prov_multi(
            plan.right, [re_ for _, re_ in plan.key_pairs], ctx
        )
        if lprov is None and rprov is None:
            raise _Unsupported("no statically bounded join side")
        lbody, lleaves, ln = self._child(plan.left, ctx)
        rbody, rleaves, rn = self._child(plan.right, ctx)
        ctx.checks.append((plan, lprov, rprov))
        body = (
            "join", plan.join_type.value,
            tuple(
                (_expr_key(le, ctx), _expr_key(re_, ctx))
                for le, re_ in plan.key_pairs
            ),
            None if plan.residual is None else _expr_key(plan.residual, ctx),
            tuple(plan.out_schema.names()),
            lbody, rbody,
        )
        return body, lleaves + rleaves, ln + rn + 1

    def _unique_prov_multi(self, plan, key_exprs, ctx):
        """Provenance for a key TUPLE: structurally unique when the keys
        are exactly a child aggregate's group columns; otherwise a stat
        check when all keys trace to columns of ONE materialized node."""
        if len(key_exprs) == 1:
            return self._unique_prov(plan, key_exprs[0], ctx)
        provs = [self._unique_prov(plan, k, ctx) for k in key_exprs]
        if any(p is None for p in provs):
            idxs = []
            for k in key_exprs:
                e = k
                while isinstance(e, lp.AliasExpr):
                    e = e.expr
                if not isinstance(e, lp.ColumnRef):
                    return None
                idxs.append(e.index)
            node = plan
            while _passes_rows(node):
                node = node.input
            if (
                isinstance(node, pp.PHashAggregate)
                and node.mode == "single"
                and sorted(idxs) == list(range(len(node.group_exprs)))
            ):
                return ("unique",)
            return None
        if any(p[0] == "unique" for p in provs):
            return ("unique",)  # any singly-unique key makes the tuple unique
        if any(p[0] != "stat" for p in provs):
            return None
        nodes = {id(p[1]) for p in provs}
        if len(nodes) != 1:
            return None
        return ("stat_multi", provs[0][1], tuple(p[2] for p in provs))

    def _unique_prov(self, plan, key_expr, ctx):
        """Provenance of a join-key expr: ("unique",) if unique by
        construction, ("stat", node, col_idx) to check a materialized batch
        column, ("via_join", node, side, inner) for columns flowing through
        an in-segment join, or None (unknown)."""
        e = key_expr
        while isinstance(e, lp.AliasExpr):
            e = e.expr
        if not isinstance(e, lp.ColumnRef):
            return None
        return self._unique_prov_idx(plan, e.index, ctx)

    def _unique_prov_idx(self, plan, idx, ctx):
        node = plan
        while True:
            if id(node) in ctx.forced or isinstance(node, pp.PScan):
                return ("stat", node, idx)
            if _passes_rows(node):
                node = node.input
                continue
            if isinstance(node, pp.PWindow):
                if idx >= len(node.input.schema()):
                    return None  # a window function's column
                node = node.input
                continue
            if isinstance(node, pp.PProjection):
                pe = node.exprs[idx]
                while isinstance(pe, lp.AliasExpr):
                    pe = pe.expr
                if not isinstance(pe, lp.ColumnRef):
                    return None
                node, idx = node.input, pe.index
                continue
            if isinstance(node, pp.PHashAggregate):
                if (node.mode == "single" and len(node.group_exprs) == 1
                        and idx == 0):
                    return ("unique",)
                return None
            if isinstance(node, pp.PHashJoin) and id(node) not in ctx.forced:
                # through an in-segment join: a column from side X gains a
                # multiplicity factor equal to the OTHER side's key dup
                n_left = len(node.left.schema())
                if idx < n_left:
                    inner = self._unique_prov_idx(node.left, idx, ctx)
                    return ("via_join", node, "L", inner)
                inner = self._unique_prov_idx(node.right, idx - n_left, ctx)
                return ("via_join", node, "R", inner)
            # opaque boundary (an eager leaf): stat on its batch
            return ("stat", node, idx)

    def _prov_max_dup(self, prov, batch_by_node, res):
        """-> max key multiplicity for this provenance, or None."""
        if prov is None:
            return None
        if prov[0] == "unique":
            return 1
        host = self.executor._host_list
        if prov[0] == "via_join":
            _, jnode, side, inner = prov
            d = self._prov_max_dup(inner, batch_by_node, res)
            if d is None:
                return None
            r = res.get(id(jnode))
            if r is None or r[0] not in ("L", "R"):
                return None  # child join demoted, or counted
            bounded_side, bdup = r
            # each row of side X appears <= (other side's key dup) times;
            # known only when the child's bounded side IS the other side
            if bounded_side == side:
                return None
            return d * bdup
        if prov[0] == "stat_multi":
            _, node, idxs = prov
            b = self._prov_batch(node, batch_by_node)
            if b is None or any(i >= len(b.columns) for i in idxs):
                return None
            return _cols_max_dup(b, list(idxs), host)
        _, node, idx = prov
        b = self._prov_batch(node, batch_by_node)
        if b is None or idx >= len(b.columns):
            return None
        return _col_max_dup(b.columns[idx], b.num_rows, host)

    def _prov_batch(self, node, batch_by_node):
        b = batch_by_node.get(id(node))
        if b is None and isinstance(node, pp.PScan):
            b = self._materialize_leaf(node)  # cheap: stored batch
        return b

    def _materialize_leaf(self, node, kind=None) -> ColumnBatch:
        """An eager subtree's batch (a table scan's stored one); `kind`
        names it in leaf_kinds, by default its node type."""
        if isinstance(node, pp.PScan):
            return self.executor._exec_scan(node)
        self.leaf_kinds[kind or type(node).__name__[1:]] += 1
        self._leaf_depth += 1
        t0 = time.perf_counter()
        try:
            return self.executor.execute(node)
        finally:
            self._leaf_depth -= 1
            if self._leaf_depth == 0:
                self.stats["leaf_ms"] += (time.perf_counter() - t0) * 1e3

    @staticmethod
    def _leaf_sig(b: ColumnBatch):
        return (
            b.capacity,
            tuple(b.schema.names()),
            tuple(str(c.data.dtype) for c in b.columns),
            tuple(
                None if c.dictionary is None else id(c.dictionary)
                for c in b.columns
            ),
            # integer-column bounds are baked into direct-grouping programs
            tuple(_bucket_bounds(_col_bounds(c)) for c in b.columns),
        )

    # ---- tracing -----------------------------------------------------------
    def _trace(self, plan, tables, leaf_ids=frozenset(), res=None) -> _TTable:
        """The body of `plan`: its inputs' bodies first, then its own work
        inside a `pipeline:<operator>` profiler range, so a profile of the
        body charges each operator its own kernels."""
        if isinstance(plan, pp.PScan) or id(plan) in leaf_ids:
            # segment leaf: a table scan, or a subtree the segment analysis
            # designated as an eager boundary
            return next(tables)
        if isinstance(plan, pp.PSubquery):  # a derived table: new names
            t = self._trace(plan.input, tables, leaf_ids, res)
            return _TTable(plan.out_schema, t.cols, t.sel, t.capacity,
                           t.dense, t.bounds)
        if isinstance(plan, pp.PLimit) and isinstance(plan.input, pp.PSort) \
                and plan.fetch is not None:
            name, op, kids = "topk", self._trace_topk, [plan.input.input]
        elif isinstance(plan, pp.PHashJoin):
            name, op, kids = "join", self._trace_join, [plan.left, plan.right]
        elif isinstance(plan, pp.PSetOp):
            name, op = "setop", self._trace_setop
            kids = [plan.left, plan.right]
        elif type(plan) in _OPERATORS:
            name = _OPERATORS[type(plan)]
            op = getattr(self, f"_trace_{name}")
            kids = [plan.input]
        else:
            raise _Unsupported(type(plan).__name__)
        ins = [self._trace(k, tables, leaf_ids, res) for k in kids]
        with torch.profiler.record_function(f"pipeline:{name}"):
            return op(plan, *ins, res=res)

    def _trace_filter(self, plan: pp.PFilter, t: _TTable, res) -> _TTable:
        mask = self.executor.evaluator.eval_predicate_mask(
            plan.predicate, _ShimBatch(t))
        return _TTable(t.schema, t.cols, t.sel & mask, t.capacity, False,
                       t.bounds)

    def _trace_projection(self, plan: pp.PProjection, t: _TTable, res
                          ) -> _TTable:
        shim = _ShimBatch(t)
        schema = plan.schema()
        cols = []
        for e, f in zip(plan.exprs, schema):
            v = self.executor.evaluator.eval(e, shim)
            cols.append(Column(v.data, v.validity, f.data_type,
                               v.dictionary))
        bounds = [_proj_bounds(e, t) for e in plan.exprs]
        return _TTable(schema, cols, t.sel, t.capacity, t.dense, bounds)

    def _trace_limit(self, plan: pp.PLimit, t: _TTable, res) -> _TTable:
        """LIMIT/OFFSET without a sort below: a rank window over sel."""
        rank = torch.cumsum(t.sel.to(torch.int64), 0) - 1
        sel = t.sel
        if plan.skip:
            sel = sel & (rank >= plan.skip)
        if plan.fetch is not None:
            sel = sel & (rank < plan.skip + plan.fetch)
        dense = t.dense and plan.skip == 0
        return _TTable(t.schema, t.cols, sel, t.capacity, dense, t.bounds)

    def _trace_join(self, plan: pp.PHashJoin, lt: _TTable, rt: _TTable,
                    res) -> _TTable:
        """An equi-join inside a program, by its resolution:

          * a unique side ("R"|"L", 1) of an INNER join, or of a LEFT
            (RIGHT) join whose unique side is the right (left): the FK fast
            path (`_trace_fk_join`), no counts and no emit;
          * ("C", None), in a count program: the join's output size raised
            as _CountReady — join_count_total on the sorted path (with its
            sorted space, which the emit program reuses), join_counts on
            direct ranks;
          * otherwise the general emit: match counts (join_ranks_counts,
            over the count program's sort when one was handed over, or
            join_counts on direct ranks), the (left, right) pairs
            left-major by join_emit_inner, then an outer side's unmatched
            rows after the pairs. Its static capacity is the counted
            bucket ("E", bucket), or the probe side's capacity times the
            multiplicity bucket of the bounded side plus the slots of the
            outer rows that side can leave unmatched.

        An outer join's residual ON condition decides matched-ness: it is
        evaluated on the emitted pairs before the unmatched rows are
        chosen (PG ON semantics; TPC-H Q13), so the output has holes and is
        not dense. The eager executor's join is the oracle."""
        ev = self.executor.evaluator
        if not self._muted:
            self.stats["joins_inlined"] += 1
        resolution = (res or {}).get(id(plan))
        if resolution is None:
            raise _Unsupported("join resolution missing")
        side, dup = resolution
        J = lp.JoinType
        jt = plan.join_type
        cap_l, cap_r = lt.capacity, rt.capacity
        left_outer = jt in (J.LEFT, J.FULL)
        right_outer = jt in (J.RIGHT, J.FULL)
        residual_outer = plan.residual is not None and jt is not J.INNER

        lkeys, rkeys = [], []
        for le, re_ in plan.key_pairs:
            lv = ev.eval(le, _ShimBatch(lt))
            rv = ev.eval(re_, _ShimBatch(rt))
            if lv.dictionary is not None or rv.dictionary is not None:
                lv, rv = unify_dicts(lv, rv)
            lkeys.append((lv.data, lv.validity))
            rkeys.append((rv.data, rv.validity))

        # direct ranks when the single key's value range is statically
        # bounded: rank = key - lo, no joint sort
        n_ranks = lr = rr = None
        if len(plan.key_pairs) == 1:
            n_ranks, lr, rr = self._direct_join_ranks(
                plan, lkeys[0], rkeys[0], lt, rt
            )

        if side == "C":
            # the count program's one scalar: pairs plus the outer rows
            # (with a residual, a row whose pairs all fail it pads too; the
            # pairs' columns are not at hand here, so every live row of an
            # outer side is counted)
            n_l = lt.sel.sum(dtype=torch.int64)
            n_r = rt.sel.sum(dtype=torch.int64)
            if n_ranks is None:
                total, ml, mr, space = K.join_count_total(
                    lkeys, rkeys, lt.sel, rt.sel, return_space=True)
            else:
                total, _, _, _, _, lm_c, rm_c = K.join_counts(
                    lr, rr, lt.sel, rt.sel)
                ml = (lm_c & lt.sel).sum(dtype=torch.int64)
                mr = (rm_c & rt.sel).sum(dtype=torch.int64)
                space = ()
            out_rows = total
            if left_outer:
                out_rows = out_rows + n_l - (0 if residual_outer else ml)
            if right_outer:
                out_rows = out_rows + n_r - (0 if residual_outer else mr)
            raise _CountReady(plan, out_rows, extras=space)

        if _fk_path(jt, resolution):
            if n_ranks is None:
                lr, rr = K.join_ranks(lkeys, rkeys, lt.sel, rt.sel)
            return self._trace_fk_join(plan, lt, rt, side, lr, rr, n_ranks)

        if side == "E":
            out_cap = dup
        else:
            probe_cap = cap_l if side == "R" else cap_r
            out_cap = probe_cap * dup
            # the bounded side's unmatched rows, and with a residual the
            # probe side's rows whose pairs all fail it, need slots of
            # their own
            if right_outer and (side == "R" or residual_outer):
                out_cap += cap_r
            if left_outer and (side == "L" or residual_outer):
                out_cap += cap_l

        if n_ranks is None:
            space = self._xfer_by_node.get(id(plan))
            if space is not None and self._compiling:
                self.stats["join_sorts_reused"] += 1
            (lr, rr, total, counts, _, rank_start, right_by_rank,
             lmatched, rmatched) = K.join_ranks_counts(
                lkeys, rkeys, lt.sel, rt.sel, space=space)
        else:
            (total, counts, _, rank_start, right_by_rank, lmatched,
             rmatched) = K.join_counts(lr, rr, lt.sel, rt.sel)
        li, ri, valid = K.join_emit_inner(
            counts, rank_start, right_by_rank, lr, total, out_cap)
        keep = valid
        if residual_outer:
            keep = valid & self._residual_on_pairs(plan, lt, rt, li, ri,
                                                   valid, out_cap)
            # matched-ness from the pairs that survive the residual
            lmatched = K._scatter_drop(cap_l, torch.where(keep, li, -1),
                                       True, False, torch.bool)
            rmatched = K._scatter_drop(cap_r, torch.where(keep, ri, -1),
                                       True, False, torch.bool)
        dev = valid.device
        pos = torch.arange(out_cap, device=dev)
        lvalid, rvalid, pad = valid, valid, torch.zeros_like(valid)
        out_rows = total
        for outer, matched, t, is_left in ((left_outer, lmatched, lt, True),
                                           (right_outer, rmatched, rt, False)):
            if not outer:
                continue
            # the unmatched live rows, after the pairs (and the left ones)
            um = ~matched & t.sel
            idx = K.compaction_indices(um, um, out_cap)
            here = (pos >= out_rows) & (pos < out_rows + um.sum(
                dtype=torch.int64))
            picked = idx[(pos - out_rows).clamp(0, out_cap - 1)]
            if is_left:
                li = torch.where(here, picked, li)
                lvalid = lvalid | here
            else:
                ri = torch.where(here, picked, ri)
                rvalid = rvalid | here
            pad = pad | here
            out_rows = out_rows + um.sum(dtype=torch.int64)
        gl_d, gl_v = K.gather_columns_packed(
            [c.data for c in lt.cols], [c.validity for c in lt.cols],
            _gather_bounds(lt), li, lvalid)
        gr_d, gr_v = K.gather_columns_packed(
            [c.data for c in rt.cols], [c.validity for c in rt.cols],
            _gather_bounds(rt), ri, rvalid)
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(gl_d + gr_d, gl_v + gr_v,
                               list(lt.cols) + list(rt.cols))
        ]
        # residual outer: the surviving pairs and the unmatched rows, with
        # holes where the residual rejected a pair (not dense: the result
        # is compacted); otherwise every emitted row up to out_rows is live
        sel = (keep | pad) if residual_outer else pos < out_rows
        # gathered columns keep their source value covers
        out = _TTable(plan.out_schema, cols, sel, out_cap,
                      not residual_outer, lt.bounds + rt.bounds)
        if plan.residual is not None and not residual_outer:
            mask = ev.eval_predicate_mask(plan.residual, _ShimBatch(out))
            out = _TTable(out.schema, out.cols, out.sel & mask, out_cap,
                          False, out.bounds)
        return out

    def _residual_on_pairs(self, plan, lt, rt, li, ri, valid, out_cap):
        """The residual ON condition over the emitted pairs: only the
        columns it reads are gathered (the full gather comes once the
        unmatched rows are merged in)."""
        refs = set()
        lp.walk_exprs(plan.residual, lambda x: refs.add(x.index)
                      if isinstance(x, lp.ColumnRef) else None)
        nlc = len(lt.cols)
        cols = {}
        for t, idx, sel_cols, off in (
                (lt, li, [i for i in sorted(refs) if i < nlc], 0),
                (rt, ri, [i - nlc for i in sorted(refs) if i >= nlc], nlc)):
            if not sel_cols:
                continue
            bounds = _gather_bounds(t)
            gd, gv = K.gather_columns_packed(
                [t.cols[i].data for i in sel_cols],
                [t.cols[i].validity for i in sel_cols],
                [bounds[i] for i in sel_cols], idx, valid)
            for i, d, v in zip(sel_cols, gd, gv):
                cols[i + off] = Column(d, v, t.cols[i].dtype,
                                       t.cols[i].dictionary)
        dev = valid.device
        all_cols = [
            cols.get(i, Column(torch.zeros(out_cap, dtype=torch.int32,
                                           device=dev),
                               torch.zeros(out_cap, dtype=torch.bool,
                                           device=dev), f.data_type, None))
            for i, f in enumerate(plan.out_schema)
        ]
        pairs = _TTable(plan.out_schema, all_cols, valid, out_cap, True,
                        [None] * len(all_cols))
        return self.executor.evaluator.eval_predicate_mask(
            plan.residual, _ShimBatch(pairs))

    def _trace_fk_join(self, plan, lt, rt, side, lr, rr, n_ranks):
        """A join with a unique side whose unmatched rows it drops (INNER,
        or LEFT/RIGHT with the unique side inner): each probe row has at
        most one match, so the build side's columns gather straight to the
        probe rows (fk_gather_by_rank, or fk_join_right_lookup +
        gather_columns_packed when a build column does not pack) and the
        probe planes pass through — no counts, no emit, no host read.
        Output rows sit at the probe side's positions; an outer join keeps
        every probe row, its unmatched ones with NULL build columns, and a
        residual that fails un-matches the pair (the build columns go
        NULL) instead of dropping the row."""
        ev = self.executor.evaluator
        n_eff = n_ranks if n_ranks is not None else lt.capacity + rt.capacity
        if side == "L":
            # mirrored FK path: the UNIQUE side is the LEFT (dim JOIN
            # fact): left columns gather by the right rows' ranks, the
            # right planes pass through
            probe, build, pr, br = rt, lt, rr, lr
        else:
            probe, build, pr, br = lt, rt, lr, rr
        bd = [c.data for c in build.cols]
        bvs = [c.validity for c in build.cols]
        fused = K.fk_gather_by_rank(
            bd, bvs, _gather_bounds(build), br,
            K.live_mask(build.capacity, build.sel), pr,
            K.live_mask(probe.capacity, probe.sel), n_eff,
        )
        if fused is not None:
            g_d, g_v, matched = fused
        else:
            bi, matched = K.fk_join_right_lookup(
                pr, br, probe.sel, build.sel, n_ranks
            )
            g_d, g_v = K.gather_columns_packed(
                bd, bvs, _gather_bounds(build), bi, matched,
                mxu_small=_mxu_gather_ok(build.capacity, self.mxu_gather),
            )
        gathered = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(g_d, g_v, build.cols)
        ]
        cols = gathered + list(rt.cols) if side == "L" \
            else list(lt.cols) + gathered
        outer = plan.join_type is not lp.JoinType.INNER
        out = _TTable(plan.out_schema, cols,
                      probe.sel if outer else probe.sel & matched,
                      probe.capacity, False, lt.bounds + rt.bounds)
        if plan.residual is not None:
            mask = ev.eval_predicate_mask(plan.residual, _ShimBatch(out))
            if outer:
                # a failing residual un-matches the pair: the probe row
                # stays, its gathered build columns go NULL
                lo = 0 if side == "L" else len(lt.cols)
                cols = [
                    Column(c.data, c.validity & mask, c.dtype, c.dictionary)
                    if lo <= i < lo + len(build.cols) else c
                    for i, c in enumerate(out.cols)
                ]
                out = _TTable(out.schema, cols, out.sel, out.capacity,
                              False, out.bounds)
            else:
                out = _TTable(out.schema, out.cols, out.sel & mask,
                              out.capacity, False, out.bounds)
        return out

    def _trace_sort_perm(self, keys, t: _TTable) -> torch.Tensor:
        shim = _ShimBatch(t)
        kvals = [self.executor.evaluator.eval(k.expr, shim) for k in keys]
        return K.sort_permutation(
            [v.data for v in kvals], [v.validity for v in kvals],
            [k.asc for k in keys], [k.resolved_nulls_first() for k in keys],
            t.sel, ranges=_key_ranges([k.expr for k in keys], kvals, t),
        )

    def _trace_topk(self, plan: pp.PLimit, t: _TTable, res) -> _TTable:
        """ORDER BY ... LIMIT k: gather only the fetched window of the sort
        permutation (k rows per column) instead of materializing the whole
        sorted table — the window bounds are static plan fields."""
        perm = self._trace_sort_perm(plan.input.keys, t)
        lo = min(plan.skip, t.capacity)
        hi = min(plan.skip + plan.fetch, t.capacity)
        wlen = hi - lo
        wcap = padded_capacity(max(wlen, 1))
        win = torch.zeros(wcap, dtype=torch.int64, device=perm.device)
        win[:wlen] = perm[lo:hi]
        n_live = t.sel.sum(dtype=torch.int64)
        # live rows pack to the front of the permutation: window position i
        # holds a live row iff lo + i < n_live (and i < wlen)
        sel = (torch.arange(wcap, device=perm.device) + lo) < \
            torch.clamp(n_live, max=hi)
        cols = [
            Column(c.data[win], c.validity[win], c.dtype, c.dictionary)
            for c in t.cols
        ]
        return _TTable(t.schema, cols, sel, wcap, True, t.bounds)

    def _direct_join_ranks(self, plan, lkey, rkey, lt, rt):
        """(n_ranks, lr, rr) via rank = key - lo when the key range is
        statically bounded and fits the downstream rank space; (None, ..)
        otherwise. NULL keys get unique negative ranks (never match), same
        convention as join_ranks."""
        (ld, lv), (rd, rv) = lkey, rkey
        cap_l, cap_r = lt.capacity, rt.capacity
        if not (_is_int(ld) and _is_int(rd)):
            return None, None, None
        le, re_ = plan.key_pairs[0]
        bl = _proj_bounds(le, lt)
        br = _proj_bounds(re_, rt)
        if bl is None or br is None:
            return None, None, None
        lo = min(bl[0], br[0])
        hi = max(bl[0] + bl[1], br[0] + br[1])
        rng = hi - lo
        # downstream consumers size rank tables at cap_l + cap_r
        if rng > min(1 << 21, cap_l + cap_r):
            return None, None, None
        iota_l = torch.arange(cap_l, device=ld.device)
        iota_r = torch.arange(cap_r, device=rd.device)
        lr = torch.where(lt.sel & lv, ld.to(torch.int64) - lo, -(iota_l + 2))
        rr = torch.where(rt.sel & rv, rd.to(torch.int64) - lo,
                         -(iota_r + cap_l + 2))
        return rng, lr, rr

    def _trace_sort(self, plan: pp.PSort, t: _TTable, res) -> _TTable:
        perm = self._trace_sort_perm(plan.keys, t)
        n_live = t.sel.sum(dtype=torch.int64)
        g_d, g_v = K.gather_columns_packed(
            [c.data for c in t.cols], [c.validity for c in t.cols],
            _gather_bounds(t), perm,
        )
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(g_d, g_v, t.cols)
        ]
        return _TTable(
            t.schema, cols, K.live_mask(t.capacity, n_live), t.capacity,
            True, t.bounds,
        )

    # ---- window / distinct / set operations ------------------------------
    def _trace_window(self, plan: pp.PWindow, t: _TTable, res) -> _TTable:
        """Each window function over its OVER spec's sort, at the input's
        capacity; the selection mask passes through.

        Shared sorts: specs with the same PARTITION BY whose ORDER BY is a
        prefix of another spec's take that spec's permutation when the
        function cannot see the order within peers (W.order_independent);
        each keeps its own segment and peer flags."""
        ev = self.executor.evaluator
        shim = _ShimBatch(t)
        cap, sel = t.capacity, t.sel
        schema = plan.schema()
        out_cols = list(t.cols)

        def spec_key(w):
            return (tuple(str(_expr_key(p)) for p in w.partition_by),
                    tuple((str(_expr_key(k.expr)), k.asc,
                           k.resolved_nulls_first()) for k in w.order_by))

        spec_keys = [spec_key(w) for w in plan.window_exprs]
        spec_exprs = {}  # spec key -> a window expr carrying those keys
        for w, sk in zip(plan.window_exprs, spec_keys):
            spec_exprs.setdefault(sk, w)
        sorts, segments, inverses = {}, {}, {}
        for wi, (w, (pk, okeys)) in enumerate(zip(plan.window_exprs,
                                                  spec_keys)):
            hk = (pk, okeys)
            if W.order_independent(w):
                for pk2, ok2 in spec_exprs:
                    if pk2 == pk and len(ok2) > len(hk[1]) \
                            and ok2[:len(okeys)] == okeys:
                        hk = (pk2, ok2)
            if hk not in sorts:
                sorts[hk] = self._window_sort(spec_exprs[hk], t, shim)
            perm, pad_sorted, parts, orders = sorts[hk]
            n_own = len(w.order_by)
            if (hk, n_own) not in segments:
                segments[(hk, n_own)] = K.window_segments(
                    parts, [p for pair in orders[:n_own] for p in pair],
                    pad_sorted)
            seg_change, peer_change, seg = segments[(hk, n_own)]

            def arg(e, perm=perm):
                """The argument in window order, packed when bounded."""
                v = ev.eval(e, shim)
                b = _proj_bounds(e, t)
                if not (b is not None and len(b) == 2):
                    b = ((0, max(len(v.dictionary), 1))
                         if v.dictionary is not None else None)
                (d,), (ok,) = K.gather_columns_packed(
                    [v.data], [v.validity], [b], perm)
                return v, d, ok

            svals, svalid, out_dict = W.sorted_values(
                w, seg_change, peer_change, seg, pad_sorted, arg)
            if hk not in inverses:
                inv = torch.empty_like(perm)
                inv[perm] = torch.arange(cap, device=perm.device)
                inverses[hk] = inv
            # back to row order: the rank family's values (1..cap) pack
            rb = (0, cap + 1) if w.func in W.RANKS else None
            (out_d,), (out_v,) = K.gather_columns_packed(
                [svals], [svalid], [rb], inverses[hk])
            if out_dict is not None:
                out_d = out_d.to(torch.int32)
            f = schema.field(len(t.cols) + wi)
            out_cols.append(Column(out_d, out_v & sel, f.data_type, out_dict))
        if self._compiling:
            self.stats["window_sorts"] += len(sorts)
            self.stats["window_specs"] += len(set(spec_keys))
        return _TTable(schema, out_cols, sel, cap, t.dense,
                       t.bounds + [None] * len(plan.window_exprs))

    def _window_sort(self, w, t: _TTable, shim):
        """One OVER spec's sort: (perm, pad flags in window order, the
        normalized partition key planes, one [null, key] pair per ORDER BY
        key). The key planes go through the permutation in one packed
        gather (bare columns carry bounds; validity bits always pack)."""
        ev = self.executor.evaluator
        part_vals = [ev.eval(p, shim) for p in w.partition_by]
        o_vals = [ev.eval(k.expr, shim) for k in w.order_by]
        key_exprs = list(w.partition_by) + [k.expr for k in w.order_by]
        kb = _key_ranges(key_exprs, part_vals + o_vals, t)
        datas = [v.data for v in part_vals + o_vals]
        valids = [v.validity for v in part_vals + o_vals]
        n_part = len(part_vals)
        if not key_exprs:
            # OVER (): a constant key keeps the live rows in input order
            datas = [torch.zeros(t.capacity, dtype=torch.int32,
                                 device=t.sel.device)]
            valids = [torch.ones(t.capacity, dtype=torch.bool,
                                 device=t.sel.device)]
            kb, n_part = [(0, 1)], 1
        ascs = [True] * n_part + [k.asc for k in w.order_by]
        nfs = [False] * n_part + [k.resolved_nulls_first()
                                  for k in w.order_by]
        perm = K.sort_permutation(datas, valids, ascs, nfs, t.sel, ranges=kb)
        g_d, g_v = K.gather_columns_packed(datas, valids, kb, perm)
        norm = [K.normalize_key(d, v) for d, v in zip(g_d, g_v)]
        parts = [p for key, null in norm[:n_part]
                 for p in (null.to(torch.int32), key)]
        orders = [[null.to(torch.int32), key] for key, null in norm[n_part:]]
        return perm, ~t.sel[perm], parts, orders

    def _trace_distinct(self, plan: pp.PDistinct, t: _TTable, res
                        ) -> _TTable:
        if plan.on is not None:
            kvals = [self.executor.evaluator.eval(e, _ShimBatch(t))
                     for e in plan.on]
            datas = [v.data for v in kvals]
            valids = [v.validity for v in kvals]
        else:
            datas = [c.data for c in t.cols]
            valids = [c.validity for c in t.cols]
        gid = torch.zeros(t.capacity, dtype=torch.int64, device=t.sel.device)
        first = K.distinct_first_flags(datas, valids, gid, t.sel)
        return _TTable(t.schema, t.cols, t.sel & first, t.capacity, False,
                       t.bounds)

    def _trace_setop(self, plan: pp.PSetOp, lt: _TTable, rt: _TTable,
                     res) -> _TTable:
        """UNION [ALL]: the two sides' planes concatenated (UNION's dedup is
        the Distinct node the planner adds above). INTERSECT / EXCEPT: the
        left rows whose key tuple does (does not) occur among the right's,
        NULLs equal, then the first of each key."""
        lvals, rvals = [], []
        for lc, rc in zip(lt.cols, rt.cols):
            lv = Val(lc.data, lc.validity, lc.dtype, lc.dictionary)
            rv = Val(rc.data, rc.validity, rc.dtype, rc.dictionary)
            if lc.dictionary is not None or rc.dictionary is not None:
                shared = _shared_dicts(plan.kind, lv, rv)
                if shared is not None:
                    lv, rv = shared
                elif self._graphs:
                    # _setop_shares_dicts expected one dictionary
                    raise _Unsupported("a set operation merges dictionaries")
                else:
                    lv, rv = unify_dicts(lv, rv)
            lvals.append(lv)
            rvals.append(rv)
        if plan.kind in (lp.SetOpKind.UNION, lp.SetOpKind.UNION_ALL):
            cols = [
                Column(torch.cat([lv.data, rv.data]),
                       torch.cat([lv.validity, rv.validity]), lc.dtype,
                       lv.dictionary)
                for lv, rv, lc in zip(lvals, rvals, lt.cols)
            ]
            return _TTable(lt.schema, cols, torch.cat([lt.sel, rt.sel]),
                           lt.capacity + rt.capacity, False,
                           [None] * len(cols))
        lr, rr = K.join_ranks([(v.data, v.validity) for v in lvals],
                              [(v.data, v.validity) for v in rvals],
                              lt.sel, rt.sel, null_equal=True)
        member = K.rank_member(lr, rr, K.live_mask(rt.capacity, rt.sel))
        keep = member if plan.kind is lp.SetOpKind.INTERSECT else ~member
        sel = lt.sel & keep
        gid = torch.zeros(lt.capacity, dtype=torch.int64, device=sel.device)
        first = K.distinct_first_flags([v.data for v in lvals],
                                       [v.validity for v in lvals], gid, sel)
        return _TTable(lt.schema, lt.cols, sel & first, lt.capacity, False,
                       lt.bounds)

    # ---- aggregate ---------------------------------------------------------
    @staticmethod
    def _key_bounds(e, v, t):
        """A group key's static cover for the packed gather: its
        dictionary's size, or its column's bounds."""
        if v.dictionary is not None:
            return (0, max(len(v.dictionary), 1))
        return _group_key_bounds(e, t)

    def _fd_dependent_keys(self, plan, leaf_ids, res):
        """Group keys functionally dependent on other group keys through a
        unique-side equi-join — TPC-H Q3's shape: GROUP BY l_orderkey,
        o_orderdate, o_shippriority where orders is unique on o_orderkey,
        so the o_* keys are determined by l_orderkey. Dropping them from
        the grouping keys turns a multi-key grouping into a single-key one
        (sort-free when the key is bounded); their values come from a
        representative row of each group.

        Sound because on the join's unique (multiplicity 1) side one key
        value matches at most one build row, so each of that side's
        columns is single-valued per probe-key value. Outer rows are safe
        only when the probe side is the outer side (their dependent
        columns are all NULL, still single-valued per key): hence the gate
        on the join type. Returns the positions of the dependent keys."""
        exprs = plan.group_exprs
        if len(exprs) < 2 or not res:
            return frozenset()

        def unwrap(e):
            while isinstance(e, lp.AliasExpr):
                e = e.expr
            return e

        def resolve(node, idx):
            """-> (terminal node id, column, [(join, side) crossed])"""
            crossings = []
            while True:
                if id(node) in leaf_ids:
                    return (id(node), idx, crossings)
                if isinstance(node, (pp.PFilter, pp.PSort, pp.PLimit,
                                     pp.PDistinct, pp.PSubquery)):
                    node = node.input
                elif isinstance(node, pp.PProjection):
                    pe = unwrap(node.exprs[idx])
                    if not isinstance(pe, lp.ColumnRef):
                        return None
                    node, idx = node.input, pe.index
                elif isinstance(node, pp.PHashJoin):
                    n_left = len(node.left.schema())
                    if idx < n_left:
                        crossings.append((node, "L"))
                        node = node.left
                    else:
                        crossings.append((node, "R"))
                        node, idx = node.right, idx - n_left
                else:
                    return (id(node), idx, crossings)

        provs = []
        for e in exprs:
            ee = unwrap(e)
            provs.append(resolve(plan.input, ee.index)
                         if isinstance(ee, lp.ColumnRef) else None)
        dep: set = set()
        joins = {id(j): j for p in provs if p for j, _ in p[2]}
        for jid, join in joins.items():
            r = res.get(jid)
            if r is None or r[0] not in ("L", "R") or r[1] != 1:
                continue
            side_b = r[0]
            jt = join.join_type
            if not (jt is lp.JoinType.INNER
                    or (jt is lp.JoinType.LEFT and side_b == "R")
                    or (jt is lp.JoinType.RIGHT and side_b == "L")):
                continue
            cand = [i for i, p in enumerate(provs)
                    if p and any(j is join and s == side_b for j, s in p[2])]
            if not cand:
                continue
            # every probe-side join key must be among the kept group keys
            probe_child = join.left if side_b == "R" else join.right
            probe_terms = []
            for le, re_ in join.key_pairs:
                pe = unwrap(le if side_b == "R" else re_)
                term = (resolve(probe_child, pe.index)
                        if isinstance(pe, lp.ColumnRef) else None)
                if term is None:
                    break
                probe_terms.append(term[:2])
            else:
                kept = {p[:2] for i, p in enumerate(provs)
                        if p and i not in cand and i not in dep}
                if all(t in kept for t in probe_terms):
                    dep.update(cand)
        if not dep or len(dep) >= len(exprs):
            return frozenset()
        return frozenset(dep)

    def _trace_aggregate(self, plan: pp.PHashAggregate, t: _TTable,
                         res) -> _TTable:
        ex = self.executor
        ev = ex.evaluator
        shim = _ShimBatch(t)
        cap = t.capacity
        sel = t.sel
        dev = sel.device
        schema = plan.schema()

        kernel_bound = None  # static dense-gid bound enabling the kernel
        bucket_mode = False
        resolution = (res or {}).get(id(plan))  # group-space count->emit
        dep_keys = self._fd_dependent_keys(plan, self._leaf_ids, res)
        if self._compiling:
            self.stats["fd_pruned_keys"] += len(dep_keys)
        if plan.group_exprs:
            gvals = [ev.eval(g, shim) for g in plan.group_exprs]
            # only the independent keys group: dense ids sorted by them
            # equal those sorted by every key, the dependent keys being
            # functions of them
            ind = [i for i in range(len(gvals)) if i not in dep_keys]
            gvals_i = [gvals[i] for i in ind]
            # direct (sort-free) grouping when the keys' value ranges are
            # statically bounded: dictionary codes (range = dict size) or
            # integer columns with leaf min/max stats
            direct = None  # (key plane, validity, lo, num_buckets)
            ranges = []  # per independent key: (lo, range) or None
            for i, v in zip(ind, gvals_i):
                if v.dictionary is not None:
                    ranges.append((0, max(len(v.dictionary), 1)))
                elif v.data.dtype == torch.bool:
                    ranges.append((0, 2))
                elif _is_int(v.data):
                    ranges.append(_group_key_bounds(plan.group_exprs[i], t))
                else:
                    ranges.append(None)
            max_range = ex._DIRECT_GROUP_MAX_RANGE
            if len(gvals_i) == 1:
                r0 = ranges[0]
                if r0 is not None and r0[1] + 1 <= max_range:
                    direct = (gvals_i[0].data, gvals_i[0].validity, r0[0],
                              r0[1])
            elif all(r is not None for r in ranges):
                # combined code: lexicographic packing with a null slot per
                # key (code R_i), matching the sort-based group order
                prod = 1
                for _, rng_i in ranges:
                    prod *= rng_i + 1
                    if prod > max_range:
                        break
                if prod <= max_range:
                    combined = None
                    for v, (lo_i, rng_i) in zip(gvals_i, ranges):
                        code = torch.where(
                            v.validity,
                            (v.data.to(torch.int64) - lo_i).clamp(
                                0, rng_i - 1),
                            rng_i,
                        )
                        combined = (code if combined is None
                                    else combined * (rng_i + 1) + code)
                    direct = (combined, torch.ones(cap, dtype=torch.bool,
                                                   device=dev), 0, prod)
            if direct is not None and padded_capacity(direct[3] + 1) <= cap:
                # BUCKET MODE: aggregate straight into the bounded bucket
                # space; the selection mask marks the observed buckets, and
                # the group-key columns come from the bucket index
                kd, kv, lo, nb = direct
                S = padded_capacity(nb + 1)
                kernel_bound = S
                lm = K.live_mask(cap, sel)
                gid = torch.where(
                    lm & kv, (kd.to(torch.int64) - lo).clamp(0, nb - 1),
                    nb,  # null-key group (pad rows masked by lm)
                )
                ng = rep = None
                bucket_mode = True
            elif direct is not None:
                kd, kv, lo, nb = direct
                gid, ng, rep = K.group_ids_direct(kd, kv, sel, lo, nb)
                S = min(padded_capacity(nb + 1), cap)
                kernel_bound = S
            else:
                # the sort-based grouping at S = capacity; a counted
                # aggregate reuses the count program's grouping (handed
                # over as planes) and skips the sort
                space = self._xfer_by_node.get(id(plan))
                if space is not None:
                    gid, ng, rep = space
                    if self._compiling:
                        self.stats["group_sorts_reused"] += 1
                else:
                    gid, ng, rep = K.group_ids(
                        [v.data for v in gvals_i],
                        [v.validity for v in gvals_i], sel, ranges=ranges,
                    )
                S = cap
            if resolution == ("C", None):
                # the count program's scalar: the groups (a bucket bound
                # met at run time caps the groups statically)
                if bucket_mode:
                    raise _CountReady(plan, S)
                raise _CountReady(plan, ng, extras=(gid, ng, rep))
            if resolution is not None and not bucket_mode:
                # the emit program aggregates at the counted bucket
                S = min(resolution[1], S)
                kernel_bound = S
        else:
            gvals = []
            gid = torch.zeros(cap, dtype=torch.int64, device=dev)
            ng = 1  # global aggregate: one row even on empty input
            rep = None
            S = min(128, cap)

        cols: List[Column] = []
        if bucket_mode:
            iota_s = torch.arange(S, device=dev)
            key_cols = {}  # group-key position -> (data, validity, dict)
            if len(gvals_i) == 1:
                v = gvals_i[0]
                key_cols[ind[0]] = ((iota_s + lo).to(v.data.dtype),
                                    iota_s < nb, v.dictionary)
            else:
                # decompose the combined lexicographic code per key
                rem = iota_s
                codes = []
                for _, rng_i in reversed(ranges):
                    codes.append(rem % (rng_i + 1))
                    rem = rem // (rng_i + 1)
                codes.reverse()
                for i, v, code, (lo_i, rng_i) in zip(ind, gvals_i, codes,
                                                     ranges):
                    key_cols[i] = ((code + lo_i).to(v.data.dtype),
                                   code < rng_i, v.dictionary)
            if dep_keys:
                # the dependent keys are single-valued per bucket, so any
                # live row of the bucket gives them: one scatter of row
                # indices makes the representative rows (the rows not
                # selected into spill slots of their own, not one shared)
                rows = torch.arange(cap, device=dev)
                rep_b = K._scatter_drop(
                    S + cap, torch.where(K.live_mask(cap, sel), gid,
                                         S + rows),
                    rows, 0, torch.int64, reduce="amax")[:S]
                dpos = sorted(dep_keys)
                g_d, g_v = K.gather_columns_packed(
                    [gvals[i].data for i in dpos],
                    [gvals[i].validity for i in dpos],
                    [self._key_bounds(plan.group_exprs[i], gvals[i], t)
                     for i in dpos], rep_b)
                for i, d, vv in zip(dpos, g_d, g_v):
                    key_cols[i] = (d, vv, gvals[i].dictionary)
            for i in range(len(gvals)):
                d, vv, dic = key_cols[i]
                cols.append(Column(d, vv, schema.field(i).data_type, dic))
        elif gvals:
            # representative-row gather of the group keys, packed
            g_d, g_v = K.gather_columns_packed(
                [v.data for v in gvals], [v.validity for v in gvals],
                [self._key_bounds(g, v, t)
                 for g, v in zip(plan.group_exprs, gvals)],
                rep[:S],
            )
            for d, vd, v, f in zip(g_d, g_v, gvals, schema):
                cols.append(Column(d, vd, f.data_type, v.dictionary))

        use_kernel = ex._mxu_agg_enabled(kernel_bound)
        # the combine of partial sums (a mesh's final aggregate,
        # partial_agg.build_partial_final): a float SUM takes two
        # fixed-point words, as spmd's final combine does
        combine = getattr(plan, "_qe_combine", False)
        agg_evals = [
            None if agg.expr is None else ev.eval_agg_arg(agg, shim)
            for agg in plan.agg_exprs
        ]

        # SUM/COUNT/AVG over the bounded dense group space: every eligible
        # column shares ONE group_agg call (the kernel on CUDA)
        items, item_of = [], {}

        def collect(data, ok_mask, key):
            if key not in item_of:
                item_of[key] = len(items)
                items.append((data, ok_mask))

        def eligible(agg, av):
            # DISTINCT aggregates take the segment route with their dedup
            # plane (as in the JAX package)
            return (use_kernel and agg.func in _KERNEL_FUNCS
                    and not agg.distinct
                    and (av is None or (av.dictionary is None
                                        and av.data.dtype != torch.bool)))

        if use_kernel:
            for agg, av in zip(plan.agg_exprs, agg_evals):
                if not eligible(agg, av):
                    continue
                if av is None:
                    collect(None, sel, "__star")  # reads only its ok plane
                else:
                    vals = (av.data if av.data.is_floating_point()
                            else av.data.to(torch.int64))
                    # AVG over a DECIMAL sums descaled values: not SUM's
                    key = (str(_expr_key(agg.expr)), str(av.dtype))
                    ok = sel & av.validity
                    if combine and vals.is_floating_point():
                        hi, lo = group_agg.two_words(vals, ok)
                        collect(hi, ok, key)
                        collect(lo, ok, key + ("lo",))
                    else:
                        collect(vals, ok, key)
            if bucket_mode:
                collect(None, sel, "__star")
        results = []
        if items:
            results = group_agg.grouped_sums_counts_multi(
                items, gid, kernel_bound
            )

        fi = len(gvals)
        for agg, av in zip(plan.agg_exprs, agg_evals):
            func = agg.func
            f = schema.field(fi)
            fi += 1
            if eligible(agg, av):
                key = "__star" if av is None else (str(_expr_key(agg.expr)),
                                                   str(av.dtype))
                sums, counts = results[item_of[key]]
                if av is not None and key + ("lo",) in item_of:
                    sums = sums + results[item_of[key + ("lo",)]][0]
                if func is lp.AggFunc.COUNT:
                    out_d = counts[:S]
                    out_v = torch.ones(S, dtype=torch.bool, device=dev)
                elif func is lp.AggFunc.SUM:
                    out_d = sums[:S]
                    out_v = counts[:S] > 0
                else:  # AVG
                    out_d = sums[:S].to(torch.float64) / counts[:S].clamp(
                        min=1)
                    out_v = counts[:S] > 0
                cols.append(Column(out_d, out_v, f.data_type, None))
                continue
            if av is None:
                fname, data, validity, arg_dict = "count_star", None, None, None
            else:
                fname = func.value.lower()
                data, validity, arg_dict = av.data, av.validity, av.dictionary
            distinct_first = None
            if agg.distinct and av is not None:
                distinct_first = K.distinct_first_flags(
                    [data], [validity], gid, sel)
            if combine and fname == "sum" and data.is_floating_point():
                vals, cnt = group_agg.two_word_sums(
                    data, K.live_mask(cap, sel) & validity, gid, S)
                valid = cnt > 0
            elif plan.group_exprs or distinct_first is not None:
                vals, valid = K.segment_aggregate(
                    fname, data, validity, gid, sel, S,
                    distinct_first=distinct_first,
                )
            else:
                vals, valid = K.global_aggregate(
                    fname,
                    data if data is not None else torch.zeros(
                        cap, dtype=torch.int64, device=dev),
                    validity if validity is not None else torch.ones(
                        cap, dtype=torch.bool, device=dev),
                    sel, S,
                )
            out_d = vals[:S]
            out_v = valid[:S]
            out_dict = (
                arg_dict
                if func in (lp.AggFunc.MIN, lp.AggFunc.MAX)
                and arg_dict is not None
                else None
            )
            if out_dict is not None:
                out_d = out_d.to(torch.int32)
            cols.append(Column(out_d, out_v, f.data_type, out_dict))

        if bucket_mode:
            # observed buckets only; shares the COUNT(*) column with any
            # COUNT(*) aggregate
            if use_kernel:
                rows_per_bucket = results[item_of["__star"]][1]
            else:
                rows_per_bucket = K._segment_count(
                    K.live_mask(cap, sel), gid, S)
            return _TTable(schema, cols, rows_per_bucket[:S] > 0, S, False,
                           [None] * len(cols))
        sel_out = torch.arange(S, device=dev) < ng
        return _TTable(schema, cols, sel_out, S, True, [None] * len(cols))


def _fk_path(join_type, resolution) -> bool:
    """A join resolved to a unique side that drops that side's unmatched
    rows (INNER, or LEFT/RIGHT with the unique side inner) takes the FK
    path: the unique side gathers to the probe rows, with no emit."""
    side, dup = resolution
    J = lp.JoinType
    return dup == 1 and (
        (side == "R" and join_type in (J.INNER, J.LEFT))
        or (side == "L" and join_type in (J.INNER, J.RIGHT)))


def _sources_read(plan, sub_exprs=()) -> set:
    """id()s of the table sources a physical plan reads, its expressions'
    subquery plans included."""
    seen, out = set(), set()
    stack = [plan] + [x.plan for x in sub_exprs]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, (list, tuple)):
            stack.extend(obj)
            continue
        if not isinstance(obj, (pp.PhysicalPlan, lp.LogicalExpr,
                                lp.LogicalPlan)):
            continue
        src = getattr(obj, "source", None)
        if isinstance(obj, (pp.PScan, pp.PIndexScan)) and src is not None:
            out.add(id(src))
        stack.extend(v for v in vars(obj).values()
                     if isinstance(v, (list, tuple, pp.PhysicalPlan,
                                       lp.LogicalExpr, lp.LogicalPlan)))
    return out


def _ptrs(planes, xfer=()):
    """The addresses a graph reads: the input planes' and the handed-over
    planes'."""
    return (tuple((d.data_ptr(), v.data_ptr()) for pl in planes
                  for d, v in pl),
            tuple(t.data_ptr() for t in _flat(xfer)))


def _flat(obj):
    """The tensors of a nest of lists and tuples, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for x in obj for t in _flat(x)]


class _Entry:
    """A cached program: the plan segment, its leaves' static facts and,
    on CUDA, the captured graph with the tensors it reads and writes."""

    __slots__ = ("plan", "leaves", "leaf_ids", "res", "checks", "counts",
                 "ordinal", "xfer_ords", "dyn_exprs", "sub_exprs", "subs",
                 "leaf_bounds", "meta", "graph", "outputs", "planes", "xfer",
                 "ptrs", "n_bufs", "dyn_bufs")

    def __init__(self, plan, leaves):
        self.plan = plan
        self.leaves = leaves  # holds dictionary refs so leaf ids stay unique
        self.leaf_ids = frozenset()
        self.res = {}
        self.checks = []      # the checked join/aggregate nodes, in order
        self.counts = False   # a count program (else an emit program)
        self.ordinal = None   # count program: the check it counts
        self.xfer_ords = ()   # emit program: the checks whose count
        # programs' planes it takes as inputs
        self.dyn_exprs = []
        self.sub_exprs = []  # subquery exprs of `plan`, traversal order
        self.subs = []  # their first batches (schemas, dictionary refs)
        self.leaf_bounds = []
        self.meta = {}
        self.graph = None     # torch.cuda.CUDAGraph once captured
        self.outputs = None   # the graph's output tensors (overwritten)
        self.planes = None    # leaf planes the graph reads (kept alive)
        self.xfer = ()        # handed-over planes the graph reads
        self.ptrs = None      # their data_ptr()s at capture
        self.n_bufs = None    # leaf row counts, 0-d int64, filled per call
        self.dyn_bufs = None  # literal values, 0-d, filled per call


def compiled_enabled() -> bool:
    return os.environ.get("QE_COMPILED", "1") != "0"
