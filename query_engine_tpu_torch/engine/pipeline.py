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

Equi-joins with a statically unique side (a GROUP BY below the key, or a
cached multiplicity stat of 1 on a leaf column) trace in-segment through
the FK fast paths. Any other join is demoted to an eager leaf: the segment
above it still compiles, with the join's result fed in as a leaf batch.
A derived table (a subquery in FROM) is a pass-through node that renames
its child's columns. Constructs outside the slice (outer and general-emit
joins, DISTINCT, windows, set operations, shared CTEs and other subqueries,
functions the evaluator lacks) raise _Unsupported and run eagerly, per
subtree. On CUDA so do the expressions that build a table on the host
(string comparisons, string IN, LIKE: `expr_eval.builds_host_table`); a
date compared with a string literal is not one of them, since the parsed
literal (`expr_eval.temporal_literal`) is a program input.

The eager executor is the semantics oracle (tests/test_torch_pipeline.py).
"""

from __future__ import annotations

import collections
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.core.schema import Schema
from query_engine_tpu_torch.core.types import TypeKind
from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, padded_capacity,
)
from query_engine_tpu_torch.engine.expr_eval import (
    builds_host_table, temporal_literal, unify_dicts,
)
from query_engine_tpu_torch.ops import group_agg, small_gather
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp


class _Unsupported(Exception):
    """Raised during segment analysis/tracing: run the subtree eagerly."""


# failures of a program body that mean "not for this slice" — run eagerly.
# Device and capture errors (RuntimeError) are not among them: they raise.
_TRACE_ERRORS = (_Unsupported, NotImplementedError, ExecutionError)


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

# operators the port's evaluator computes (engine/expr_eval.py)
_TRACEABLE_BINOPS = {
    lp.BinOp.AND, lp.BinOp.OR, lp.BinOp.EQ, lp.BinOp.NEQ, lp.BinOp.LT,
    lp.BinOp.LTE, lp.BinOp.GT, lp.BinOp.GTE, lp.BinOp.ADD, lp.BinOp.SUB,
    lp.BinOp.MUL, lp.BinOp.DIV, lp.BinOp.LIKE, lp.BinOp.NOT_LIKE,
    lp.BinOp.ILIKE, lp.BinOp.NOT_ILIKE,
}


def _expr_traceable(e: lp.LogicalExpr) -> bool:
    """Static check that a program body can evaluate the expression: the
    node kinds and operators the port's evaluator supports (JAX's rule
    rejects host work — UDFs, string building — which the port's evaluator
    does not have at all)."""
    bad = []

    def visit(x):
        if isinstance(x, lp.BinaryExpr):
            if x.op not in _TRACEABLE_BINOPS:
                bad.append(x)
        elif isinstance(x, lp.Literal):
            if x.value.dtype.kind is TypeKind.DECIMAL128:
                bad.append(x)
        elif isinstance(x, lp.ScalarFnExpr):
            if x.func is not lp.ScalarFn.EXTRACT:
                bad.append(x)
        elif not isinstance(x, (lp.ColumnRef, lp.AliasExpr, lp.UnaryExpr,
                                lp.CastExpr, lp.IsNullExpr, lp.CaseExpr,
                                lp.InListExpr)):
            bad.append(x)

    lp.walk_exprs(e, visit)
    return not bad


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
    new value."""
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
    if isinstance(e, lp.AliasExpr):
        # alias names land in the output schema -> they are part of the key
        return ("as", e.alias, _expr_key(e.expr, ctx))
    # the date literal this node parses (the literal or the cast), if any
    node, value = (ctx is not None and temporal_literal(e)) or (None, None)
    if isinstance(e, lp.BinaryExpr):
        return ("bin", e.op.value, *(
            _dyn_int(x, value, ctx) if x is node else _expr_key(x, ctx)
            for x in (e.left, e.right)))
    if isinstance(e, lp.UnaryExpr):
        return ("un", e.op.value, _expr_key(e.expr, ctx))
    if isinstance(e, lp.CastExpr):
        return ("cast", str(e.target), _dyn_int(e, value, ctx) if node is e
                else _expr_key(e.expr, ctx))
    if isinstance(e, lp.ScalarFnExpr):
        return ("fn", e.func.value, tuple(_expr_key(a, ctx) for a in e.args))
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
    raise _Unsupported(f"expr {type(e).__name__}")


def _passes_rows(node) -> bool:
    """A node whose output columns are its input's (a subset of its rows, a
    new order, or new names): key multiplicities seen below hold above."""
    return isinstance(node, (pp.PFilter, pp.PSort, pp.PLimit)) or (
        isinstance(node, pp.PSubquery) and not node.shared)


def _sort_key_key(k: lp.SortKey, ctx=None):
    return (_expr_key(k.expr, ctx), k.asc, k.resolved_nulls_first())


# single-input nodes a program body traces: node type -> _trace_<name>
_OPERATORS = {pp.PFilter: "filter", pp.PProjection: "projection",
              pp.PSort: "sort", pp.PLimit: "limit",
              pp.PHashAggregate: "aggregate"}

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
    duplication checks, and dynamic-literal collection."""

    __slots__ = ("forced", "checks", "dyn_vals", "dyn_exprs")

    def __init__(self, forced):
        self.forced = forced
        self.checks = []  # (join node, left provenance, right provenance)
        self.dyn_vals = []   # (tag, python value), traversal order
        self.dyn_exprs = []  # the literal exprs (kept alive via entry.plan)


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
                      "captures": 0, "replays": 0,
                      # host-clock ms in the eager subtrees run as leaves
                      # (the outermost ones) and in captures outside them
                      "leaf_ms": 0.0, "capture_ms": 0.0}
        self.leaf_kinds = collections.Counter()  # eager leaves by node type
        self._leaf_depth = 0

    # ---- entry -----------------------------------------------------------
    def try_execute(self, plan: pp.PhysicalPlan) -> Optional[ColumnBatch]:
        """Returns the result batch, or None to run the eager path."""
        host = self.executor._host_list
        forced: set = set()
        while True:  # joins without a unique side demote to eager leaves
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

            # resolve join duplication stats. Only unique sides (dup 1)
            # trace in this slice; a join JAX would give a bounded emit or a
            # count->emit program becomes an eager leaf instead
            res = {}
            demoted = False
            for jnode, lprov, rprov in ctx.checks:
                dl = self._prov_max_dup(lprov, batch_by_node, res)
                dr = self._prov_max_dup(rprov, batch_by_node, res)
                side = None
                # prefer the right (build) side on ties
                if dr is not None and (dl is None or dr <= dl):
                    side = ("R", _dup_bucket(dr))
                elif dl is not None:
                    side = ("L", _dup_bucket(dl))
                if side is None or side[1] != 1:
                    forced.add(id(jnode))
                    self.stats["joins_demoted"] += 1
                    demoted = True
                    break
                res[id(jnode)] = side
            if not demoted:
                break

        dyn_vals = tuple(ctx.dyn_vals)
        leaf_sigs = tuple(self._leaf_sig(b) for b in leaves)
        sides = tuple(res[id(j)] for j, _, _ in ctx.checks)
        key = (key_body, leaf_sigs, sides,
               tuple(tag for tag, _ in dyn_vals))
        entry = self._cache.get(key)

        if entry is None:
            entry = _Entry(plan, leaves)
            entry.leaf_ids = frozenset(map(id, leaf_nodes))
            entry.res = res
            entry.dyn_exprs = list(ctx.dyn_exprs)
            entry.leaf_bounds = [
                [None if (bb := _bucket_bounds(_col_bounds(c))) is None
                 or bb == ("big",) else bb for c in b.columns]
                for b in leaves
            ]
            try:
                out = self._first_run(entry, leaves, dyn_vals)
            except _TRACE_ERRORS:
                self._eager_bodies.add(key_body)
                self.stats["fallbacks"] += 1
                return None
            self._cache[key] = entry
            self.stats["compiles"] += 1
        else:
            self.stats["hits"] += 1
            out = self._rerun(entry, leaves, dyn_vals)

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

    # ---- running a program -------------------------------------------------
    def _body(self, entry, planes, n_bufs, dyn_bufs):
        """The program: the plan segment over the leaf planes, row-count
        tensors and literal tensors. Reads nothing from the device."""
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
                bounds=list(bounds),
            )
            for pl, n, b, bounds in zip(planes, n_bufs, entry.leaves,
                                        entry.leaf_bounds)
        ]
        ev = self.executor.evaluator
        ev._dyn_literals = {
            id(e): v for e, v in zip(entry.dyn_exprs, dyn_bufs)
        }
        try:
            t = self._trace(entry.plan, iter(tables), entry.leaf_ids,
                            entry.res)
        finally:
            ev._dyn_literals = None
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

    def _inputs(self, leaves, dyn_vals):
        dev = self.executor.device
        planes = [[(c.data, c.validity) for c in b.columns] for b in leaves]
        n_bufs = [torch.tensor(b.num_rows, dtype=torch.int64, device=dev)
                  for b in leaves]
        dyn_bufs = [torch.tensor(v, dtype=_DYN_DTYPES[tag], device=dev)
                    for tag, v in dyn_vals]
        return planes, n_bufs, dyn_bufs

    def _first_run(self, entry, leaves, dyn_vals):
        """Run the body once eagerly; on CUDA, then capture it."""
        planes, n_bufs, dyn_bufs = self._inputs(leaves, dyn_vals)
        out = self._body(entry, planes, n_bufs, dyn_bufs)
        if self._graphs:
            self._capture(entry, planes, n_bufs, dyn_bufs)
        return out

    def _rerun(self, entry, leaves, dyn_vals):
        if entry.graph is None:  # CPU: run the body again
            return self._body(entry, *self._inputs(leaves, dyn_vals))
        planes = [[(c.data, c.validity) for c in b.columns] for b in leaves]
        if _ptrs(planes) != entry.ptrs:
            # a leaf's planes changed (table registered anew): the graph
            # would read the old addresses, so capture over the new ones
            self._capture(entry, planes, entry.n_bufs, entry.dyn_bufs)
        for buf, b in zip(entry.n_bufs, leaves):
            buf.fill_(b.num_rows)
        for buf, (_, v) in zip(entry.dyn_bufs, dyn_vals):
            buf.fill_(v)
        entry.graph.replay()
        self.stats["replays"] += 1
        return entry.outputs

    def _capture(self, entry, planes, n_bufs, dyn_bufs):
        """Capture the body into a CUDA graph over these inputs. The entry
        keeps the input tensors alive: the graph reads their addresses."""
        entry.graph = entry.outputs = None  # free the old graph's pool
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = self._body(entry, planes, n_bufs, dyn_bufs)
        if self._leaf_depth == 0:
            self.stats["capture_ms"] += (time.perf_counter() - t0) * 1e3
        entry.graph = graph
        entry.outputs = outputs
        entry.planes = planes
        entry.ptrs = _ptrs(planes)
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
        try:
            return self._plan_key(plan, ctx)
        except _Unsupported:
            # drop state collected by the failed subtree: phantom dyn
            # literals would misalign against the key's slots
            del ctx.checks[cp_checks:]
            del ctx.dyn_vals[cp_dyn:]
            del ctx.dyn_exprs[cp_dyn:]
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
            if any(a.func not in _AGG_FUNCS or a.distinct
                   for a in plan.agg_exprs):
                raise _Unsupported("aggregate function")
            exprs = list(plan.group_exprs) + [
                a.expr for a in plan.agg_exprs if a.expr is not None
            ]
            if not all(self._traceable(e) for e in exprs):
                raise _Unsupported("aggregate exprs")
            body, leaves, n = self._child(plan.input, ctx)
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
                # a WITH query referenced more than once: not in the slice
                raise _Unsupported("shared CTE")
            # a derived table: a pass-through node that renames its child
            body, leaves, n = self._child(plan.input, ctx)
            return ("subq", tuple(plan.out_schema.names()), body), leaves, n
        # anything else: eager leaf boundary (distinct, window, set op, ...)
        raise _Unsupported(type(plan).__name__)

    def _plan_key_join(self, plan: pp.PHashJoin, ctx):
        """An INNER equi-join joins the segment when one side's key is
        statically unique: a GROUP BY above the key (structural) or a cached
        multiplicity stat of 1 on the leaf column (valid under the
        filters/sorts/limits between leaf and join — subsets only shrink
        multiplicities). Other joins are demoted to eager leaves by
        try_execute (the segment above still compiles)."""
        if plan.join_type is not lp.JoinType.INNER or not plan.key_pairs:
            raise _Unsupported(f"{plan.join_type.value} join")
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
            if r is None:
                return None  # child join demoted
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

    def _materialize_leaf(self, node) -> ColumnBatch:
        if isinstance(node, pp.PScan):
            return self.executor._exec_scan(node)
        self.leaf_kinds[type(node).__name__[1:]] += 1
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
        """INNER equi-join with a statically unique side: each probe row
        has at most one match, so the build side's columns gather straight
        to the probe rows (fk_gather_by_rank, or fk_join_right_lookup +
        gather_columns_packed when a build column does not pack) and the
        probe planes pass through — no counts, no emit, no host read.
        Output rows sit at the probe side's positions."""
        ev = self.executor.evaluator
        self.stats["joins_inlined"] += 1
        resolution = (res or {}).get(id(plan))
        if resolution is None or resolution[1] != 1:
            raise _Unsupported("join resolution missing")
        side = resolution[0]
        cap_l, cap_r = lt.capacity, rt.capacity

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
        if n_ranks is None:
            lr, rr = K.join_ranks(lkeys, rkeys, lt.sel, rt.sel)
        n_eff = n_ranks if n_ranks is not None else cap_l + cap_r

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
        if side == "L":
            cols = gathered + list(rt.cols)
        else:
            cols = list(lt.cols) + gathered
        out = _TTable(plan.out_schema, cols, probe.sel & matched,
                      probe.capacity, False, lt.bounds + rt.bounds)
        if plan.residual is not None:
            mask = ev.eval_predicate_mask(plan.residual, _ShimBatch(out))
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

    # ---- aggregate ---------------------------------------------------------
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
        if plan.group_exprs:
            gvals = [ev.eval(g, shim) for g in plan.group_exprs]
            # direct (sort-free) grouping when the keys' value ranges are
            # statically bounded: dictionary codes (range = dict size) or
            # integer columns with leaf min/max stats
            direct = None  # (key plane, validity, lo, num_buckets)
            ranges = []  # per key: (lo, range) or None
            for g, v in zip(plan.group_exprs, gvals):
                if v.dictionary is not None:
                    ranges.append((0, max(len(v.dictionary), 1)))
                elif v.data.dtype == torch.bool:
                    ranges.append((0, 2))
                elif _is_int(v.data):
                    ranges.append(_group_key_bounds(g, t))
                else:
                    ranges.append(None)
            max_range = ex._DIRECT_GROUP_MAX_RANGE
            if len(gvals) == 1:
                r0 = ranges[0]
                if r0 is not None and r0[1] + 1 <= max_range:
                    direct = (gvals[0].data, gvals[0].validity, r0[0], r0[1])
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
                    for v, (lo_i, rng_i) in zip(gvals, ranges):
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
                # unbounded keys: sort-based grouping at S = capacity (the
                # group-space count->emit program is not in this slice)
                gid, ng, rep = K.group_ids(
                    [v.data for v in gvals], [v.validity for v in gvals], sel,
                    ranges=ranges,
                )
                S = cap
        else:
            gvals = []
            gid = torch.zeros(cap, dtype=torch.int64, device=dev)
            ng = 1  # global aggregate: one row even on empty input
            rep = None
            S = min(128, cap)

        cols: List[Column] = []
        if bucket_mode:
            iota_s = torch.arange(S, device=dev)
            if len(gvals) == 1:
                v = gvals[0]
                cols.append(Column((iota_s + lo).to(v.data.dtype),
                                   iota_s < nb, schema.field(0).data_type,
                                   v.dictionary))
            else:
                # decompose the combined lexicographic code per key
                rem = iota_s
                codes = []
                for _, rng_i in reversed(ranges):
                    codes.append(rem % (rng_i + 1))
                    rem = rem // (rng_i + 1)
                codes.reverse()
                for i, (v, code, (lo_i, rng_i)) in enumerate(
                        zip(gvals, codes, ranges)):
                    cols.append(Column((code + lo_i).to(v.data.dtype),
                                       code < rng_i,
                                       schema.field(i).data_type,
                                       v.dictionary))
        elif gvals:
            # representative-row gather of the group keys, packed
            kb = []
            for g, v in zip(plan.group_exprs, gvals):
                if v.dictionary is not None:
                    kb.append((0, max(len(v.dictionary), 1)))
                else:
                    kb.append(_group_key_bounds(g, t))
            g_d, g_v = K.gather_columns_packed(
                [v.data for v in gvals], [v.validity for v in gvals],
                kb, rep[:S],
            )
            for d, vd, v, f in zip(g_d, g_v, gvals, schema):
                cols.append(Column(d, vd, f.data_type, v.dictionary))

        use_kernel = ex._mxu_agg_enabled(kernel_bound)
        agg_evals = [
            None if agg.expr is None else ev.eval(agg.expr, shim)
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
            return (use_kernel and agg.func in _KERNEL_FUNCS
                    and (av is None or (av.dictionary is None
                                        and av.data.dtype != torch.bool)))

        if use_kernel:
            for agg, av in zip(plan.agg_exprs, agg_evals):
                if not eligible(agg, av):
                    continue
                if av is None:
                    collect(torch.ones(cap, dtype=torch.int64, device=dev),
                            sel, "__star")
                else:
                    vals = (av.data if av.data.is_floating_point()
                            else av.data.to(torch.int64))
                    collect(vals, sel & av.validity, str(_expr_key(agg.expr)))
            if bucket_mode:
                collect(torch.ones(cap, dtype=torch.int64, device=dev), sel,
                        "__star")
        results = []
        if items:
            results = group_agg.grouped_sums_counts_multi(
                items, gid.to(torch.int32), kernel_bound
            )

        fi = len(gvals)
        for agg, av in zip(plan.agg_exprs, agg_evals):
            func = agg.func
            f = schema.field(fi)
            fi += 1
            if eligible(agg, av):
                key = "__star" if av is None else str(_expr_key(agg.expr))
                sums, counts = results[item_of[key]]
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
            if not plan.group_exprs:
                vals, valid = K.global_aggregate(
                    fname,
                    data if data is not None else torch.zeros(
                        cap, dtype=torch.int64, device=dev),
                    validity if validity is not None else torch.ones(
                        cap, dtype=torch.bool, device=dev),
                    sel, S,
                )
            else:
                vals, valid = K.segment_aggregate(
                    fname, data, validity, gid, sel, S,
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
                rows_per_bucket = K._segment_sum(
                    K.live_mask(cap, sel).to(torch.int64), gid, S)
            return _TTable(schema, cols, rows_per_bucket[:S] > 0, S, False,
                           [None] * len(cols))
        sel_out = torch.arange(S, device=dev) < ng
        return _TTable(schema, cols, sel_out, S, True, [None] * len(cols))


def _ptrs(planes):
    return tuple((d.data_ptr(), v.data_ptr())
                 for pl in planes for d, v in pl)


class _Entry:
    """A cached program: the plan segment, its leaves' static facts and,
    on CUDA, the captured graph with the tensors it reads and writes."""

    __slots__ = ("plan", "leaves", "leaf_ids", "res", "dyn_exprs",
                 "leaf_bounds", "meta", "graph", "outputs", "planes", "ptrs",
                 "n_bufs", "dyn_bufs")

    def __init__(self, plan, leaves):
        self.plan = plan
        self.leaves = leaves  # holds dictionary refs so leaf ids stay unique
        self.leaf_ids = frozenset()
        self.res = {}
        self.dyn_exprs = []
        self.leaf_bounds = []
        self.meta = {}
        self.graph = None     # torch.cuda.CUDAGraph once captured
        self.outputs = None   # the graph's output tensors (overwritten)
        self.planes = None    # leaf planes the graph reads (kept alive)
        self.ptrs = None      # their data_ptr()s at capture
        self.n_bufs = None    # leaf row counts, 0-d int64, filled per call
        self.dyn_bufs = None  # literal values, 0-d, filled per call


def compiled_enabled() -> bool:
    return os.environ.get("QE_COMPILED", "1") != "0"
