"""Distributed compiled pipelines: a SQL physical plan -> ONE program over
the device mesh.

The counterpart of `query_engine_tpu.parallel.mesh_pipeline`.
`Session(mesh=...)` routes eligible queries here: leaf tables are sharded
row-wise over the mesh ('data' axis = the row dimension), every node that
needs co-partitioned data (join / grouped aggregate / global sort /
distinct) inserts an all-to-all exchange, and everything else — filters,
projections, the local halves of joins/aggregates/sorts — runs through
the SAME single-chip segment tracer (engine/pipeline.py
CompiledPipeline._trace) over the per-shard planes. The whole query is one
`spmd.shard_map` program: each shard's body runs in a host thread of its
own, on its shard's device, and the collectives (`spmd.all_to_all`,
`all_gather`, `psum`, `pmax`) meet at a barrier. No per-stage host hops,
no serialization, no RPC.

A program is cached by its plan's structure, its leaves' signatures, its
join resolutions, the mesh size, the shard capacities and the exchange
factor, as the reference's jitted programs are. Where the reference traces
a program once, here every call runs the bodies eagerly: per-compile
stats (`cp.stats`' joins_inlined, join_sorts_reused, fd_pruned_keys,
group_sorts_reused, window_sorts, window_specs, and this pipeline's
agg_partial_final) count on an entry's first run, from shard 0. No CUDA
graph capture spans the shard threads. The bodies branch only on static
facts (capacities, bounds, the plan's shape), so every shard reaches the
same collectives in the same order.

Exchanges are capacity-bounded by default: each shard's send buffer to each
destination is the balanced share x a growth factor (multiples of 128, not
pow2 — pow2 rounding alone costs up to 2x work inflation). Overflow is
detected in-program (one psum'd scalar), and `try_execute` retries with the
factor doubled — count-then-emit at the mesh level. Working factors are
remembered per plan shape, so steady state is one program run.

The result stays on the mesh's home device: `_assemble` compacts the
shards' selected rows there with one host read of their count.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, padded_capacity,
)
from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.engine import window as W
from query_engine_tpu_torch.engine.expr_eval import unify_dicts
from query_engine_tpu_torch.engine.partial_agg import (
    build_partial_final, partial_eligible,
)
from query_engine_tpu_torch.engine.pipeline import (
    _CountReady, _SegCtx, _ShimBatch, _TRACE_ERRORS, _TTable, _Unsupported,
    _DYN_DTYPES, _bucket_bounds, _col_bounds, _dup_bucket, _expr_key,
    _expr_traceable, _sort_key_key, ensure_bounds,
)
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.parallel import spmd
from query_engine_tpu_torch.parallel.mesh import Mesh, P, ShardedTable
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

# the largest counted emit a mesh program allocates per shard, in rows
_MAX_COUNTED = 1 << 26

# global aggregates (no GROUP BY) combine across shards with these partial
# plans: func -> (partial segment funcs, combine funcs)
_GLOBAL_PARTIAL = {
    lp.AggFunc.COUNT: (("count",), ("sum",)),
    lp.AggFunc.SUM: (("sum",), ("sum",)),
    lp.AggFunc.MIN: (("min",), ("min",)),
    lp.AggFunc.MAX: (("max",), ("max",)),
    lp.AggFunc.AVG: (("sum", "count"), ("sum", "sum")),
}

_GW_ARG_KINDS = ("INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16",
                 "UINT32", "UINT64", "FLOAT32", "FLOAT64", "DATE32",
                 "DATE64", "TIMESTAMP")


def _order_pristine(p) -> bool:
    """True when the physical subtree preserves row order shard-monotonely:
    leaf tables shard as contiguous row blocks (parallel/mesh.py
    ShardedTable), filters/projections keep rows in their slots, and the
    bucketing exchange is stable in (source shard, source slot) order
    (spmd.bucket_rows / exchange_columns) — so after a range exchange the
    per-shard slot order equals the original global row order, and a stable
    local sort reproduces the single-device engine's within-tie order
    exactly. Join/aggregate/sort/distinct/window/set-op nodes re-emit rows
    in a mesh-specific order and break this; any other node demotes to an
    eager leaf (single-device result, contiguous shards) which is pristine
    again."""
    if isinstance(p, pp.PScan):
        return True
    if isinstance(p, (pp.PFilter, pp.PProjection, pp.PSubquery)):
        return _order_pristine(p.input)
    if isinstance(p, (pp.PHashJoin, pp.PHashAggregate, pp.PSort,
                      pp.PDistinct, pp.PWindow, pp.PSetOp)):
        return False
    return True  # demotes to an eager leaf: single-device order


def _i64(x) -> torch.Tensor:
    return x.to(torch.int64)


def _slot0(val: torch.Tensor, size: int) -> torch.Tensor:
    """A [size] plane holding `val` (0-d) in slot 0 and zeros after."""
    iota = torch.arange(size, device=val.device)
    return torch.where(iota == 0, val, torch.zeros((), dtype=val.dtype,
                                                   device=val.device))


def _static_facts(b: ColumnBatch):
    """What a program keeps of an input batch: its schema, capacity and
    columns' types and dictionaries (not its planes, so a replaced table's
    planes are not kept alive by a cached program)."""
    return (b.schema, b.capacity, [(c.dtype, c.dictionary) for c in b.columns],
            [None if (bb := _bucket_bounds(_col_bounds(c))) is None
             or bb == ("big",) else bb for c in b.columns])


class _MEntry:
    __slots__ = ("fn", "meta", "plan", "res", "dyn_exprs", "sub_exprs",
                 "leaf_nodes", "factor")

    def __init__(self, plan, leaf_nodes):
        self.plan = plan
        self.leaf_nodes = leaf_nodes
        self.meta: Dict = {}
        self.fn = None
        self.res = {}
        self.dyn_exprs = []
        self.sub_exprs = []
        self.factor = None


class MeshPipeline:
    """Lowers physical plans to shard_map programs over `mesh`.

    Reuses the single-chip CompiledPipeline's trace machinery for all
    shard-local computation, so operator semantics (expression eval, join
    emit, aggregate typing, sort keys) are shared with the single-device
    engine.
    """

    def __init__(self, executor, mesh: Mesh, axis: str = "data",
                 base_factor: float = spmd.DEFAULT_RECV_FACTOR):
        self.executor = executor
        self.cp = executor.pipeline
        self.mesh = mesh
        self.axis = axis
        self.n = int(mesh.size)
        self.base_factor = base_factor
        self._cache: Dict = {}
        self._factor_memory: Dict = {}  # body -> last working factor
        self._fallback_bodies = set()
        self.stats = {"compiles": 0, "hits": 0, "fallbacks": 0,
                      "exchanges": 0, "overflow_retries": 0, "queries": 0,
                      "eager_leaves": 0, "eager_rows": 0,
                      "joins_counted": 0, "agg_partial_final": 0,
                      "eager_mesh_recursed": 0}
        # per-query demotion census of the LAST mesh-lowered query
        self.last_census = None

    # ---- entry -----------------------------------------------------------
    def try_execute(self, pplan: pp.PhysicalPlan) -> Optional[ColumnBatch]:
        """Returns the result batch, or None to run the single-device path."""
        if self.n < 2:
            return None
        limit = None
        plan = pplan
        if isinstance(plan, pp.PLimit):
            # root LIMIT applies after the gather (a global sort below it
            # already leaves shards range-ordered)
            limit = (plan.skip, plan.fetch)
            plan = plan.input

        ctx = _SegCtx(set())
        try:
            body, leaf_nodes, n_compute, n_exchange = self._mplan_key(
                plan, ctx
            )
        except _Unsupported:
            return None
        if n_compute == 0 or isinstance(plan, pp.PScan):
            return None  # trivial: the single-chip path is strictly cheaper
        if body in self._fallback_bodies:
            self.stats["fallbacks"] += 1
            return None

        host = self.executor._host_list
        leaves = [self._materialize_eager(nd) for nd in leaf_nodes]
        if any(not b.columns for b in leaves):
            return None
        for b in leaves:
            ensure_bounds(b, host)
        batch_by_node = dict(zip(map(id, leaf_nodes), leaves))

        # eager-leaf census: a leaf that is not a plain table scan is a
        # DEMOTED subtree — computed single-device, then fed into the
        # mesh program. "Zero fallbacks" alone can hide a heavy join
        # running on one device; this makes the demotions first-class stats.
        eager_idx = [i for i, nd in enumerate(leaf_nodes)
                     if not isinstance(nd, pp.PScan)]
        self.last_census = {
            "eager_leaves": len(eager_idx),
            "eager_rows": int(sum(leaves[i].num_rows for i in eager_idx)),
            "eager_kinds": [type(leaf_nodes[i]).__name__ for i in eager_idx],
            "leaves": len(leaf_nodes),
            "n_compute": n_compute,
            "n_exchange": n_exchange,
        }

        # join resolution: bounded sides get a static emit capacity; a join
        # with unbounded key duplication goes through a MESH count->emit
        # sync — one extra cached program (the count program) returns the
        # max per-shard emit size via spmd.pmax, then the emit program is
        # fully static. The single-chip count->emit pattern lifted to the
        # mesh.
        res = {}
        counted = []
        for jnode, lprov, rprov in ctx.checks:
            dl = self.cp._prov_max_dup(lprov, batch_by_node, res)
            dr = self.cp._prov_max_dup(rprov, batch_by_node, res)
            side = None
            if dr is not None and (dl is None or dr <= dl):
                side = ("R", _dup_bucket(dr))
            elif dl is not None:
                side = ("L", _dup_bucket(dl))
            if side is None or side[1] is None:
                res[id(jnode)] = ("C", None)
                counted.append(jnode)
            else:
                res[id(jnode)] = side
        if len(counted) > 1:
            return None  # one counted join per mesh program (rare shape)

        sub_batches = [self.executor.execute(x.plan) for x in ctx.sub_exprs]
        shards = [self._shard_leaf(b) for b in leaves]
        sub_args, sub_sigs = [], []
        for b in sub_batches:
            sub_args.append(self._replicate_batch(b))
            sub_sigs.append(self.cp._leaf_sig(b))
        leaf_sigs = tuple(self.cp._leaf_sig(b) for b in leaves)
        home = self.mesh.home
        dyn_args = tuple(torch.tensor(v, dtype=_DYN_DTYPES[tag], device=home)
                         for tag, v in ctx.dyn_vals)

        factor = self._factor_memory.get(body, self.base_factor)
        self.stats["queries"] += 1

        if counted:
            # count program: same body, but the counted join raises
            # _CountReady with its per-shard output size; the program
            # returns pmax(count) + the psum'd exchange overflow. Runs
            # under the same factor grow-and-retry loop as the emit
            # program (its exchanges are bounded too).
            jnode = counted[0]
            while True:
                sides_c = tuple(res[id(j)] for j, _, _ in ctx.checks)
                ckey = (body, leaf_sigs, tuple(sub_sigs), sides_c, self.n,
                        tuple(st.shard_capacity for st in shards), factor,
                        "count")
                centry = self._cache.get(ckey)
                args = self._flat_args(shards, sub_args, dyn_args)
                if centry is None:
                    centry = self._new_entry(plan, ctx, leaf_nodes,
                                             dict(res), factor)
                    centry.fn = self._build_fn(centry, leaves, sub_batches,
                                               shards, factor,
                                               count_mode=True)
                    try:
                        out = centry.fn(args)
                    except _TRACE_ERRORS:
                        self._fallback_bodies.add(body)
                        self.stats["fallbacks"] += 1
                        return None
                    self._cache[ckey] = centry
                    self.stats["compiles"] += 1
                else:
                    self.stats["hits"] += 1
                    out = centry.fn(args)
                # one read of the count and the overflow
                out_rows, overflow = host(torch.cat([out[0], out[1]]))
                if overflow == 0:
                    break
                self.stats["overflow_retries"] += 1
                if factor >= self.n:
                    return None
                factor = min(factor * 2.0, float(self.n))
            bucket = 128
            while bucket < out_rows:
                bucket *= 2
            if bucket > _MAX_COUNTED:  # memory guard on the counted size
                return None  # data-dependent: no body blacklist
            res[id(jnode)] = ("E", bucket)
            self.stats["joins_counted"] += 1

        sides = tuple(res[id(j)] for j, _, _ in ctx.checks)
        while True:
            key = (body, leaf_sigs, tuple(sub_sigs), sides, self.n,
                   tuple(st.shard_capacity for st in shards), factor)
            entry = self._cache.get(key)
            args = self._flat_args(shards, sub_args, dyn_args)
            if entry is None:
                entry = self._new_entry(plan, ctx, leaf_nodes, res, factor)
                entry.fn = self._build_fn(entry, leaves, sub_batches, shards,
                                          factor)
                try:
                    out = entry.fn(args)
                except _TRACE_ERRORS:
                    self._fallback_bodies.add(body)
                    self.stats["fallbacks"] += 1
                    return None
                self._cache[key] = entry
                self.stats["compiles"] += 1
                self.stats["exchanges"] += n_exchange
            else:
                self.stats["hits"] += 1
                out = entry.fn(args)

            datas, valids, sel, overflow = out
            # one read of the overflow and the result's row count
            overflow, total = host(torch.stack(
                [overflow.reshape(()), sel.sum(dtype=torch.int64)]))
            if overflow == 0:
                break
            # a bounded exchange dropped rows: double the factor and retry
            # (grow-and-retry; the factor memory makes this a one-time cost
            # per plan shape)
            self.stats["overflow_retries"] += 1
            if factor >= self.n:
                return None  # should not happen: factor n is worst-case
            factor = min(factor * 2.0, float(self.n))
        self._factor_memory[body] = factor

        if eager_idx:
            self.stats["eager_leaves"] += len(eager_idx)
            self.stats["eager_rows"] += self.last_census["eager_rows"]
        return self._assemble(entry, datas, valids, sel, total, limit)

    @staticmethod
    def _new_entry(plan, ctx, leaf_nodes, res, factor):
        entry = _MEntry(plan, leaf_nodes)
        entry.res = res
        entry.dyn_exprs = list(ctx.dyn_exprs)
        entry.sub_exprs = list(ctx.sub_exprs)
        entry.factor = factor
        return entry

    # ---- host-side helpers ----------------------------------------------
    def _materialize_eager(self, nd) -> ColumnBatch:
        """Materialize a leaf subtree. Plain scans read the stored batch;
        DEMOTED subtrees first retry the mesh on the subtree itself (its
        own root was the unsupported node, but its INPUT may lower — e.g.
        a shared CTE whose aggregate should run sharded), falling back to
        the single-device executor."""
        if isinstance(nd, pp.PScan):
            return self.cp._materialize_leaf(nd)
        if isinstance(nd, pp.PSubquery) and nd.shared:
            # keep the executor's once-per-query CTE memo (PG semantics +
            # bit-identical floats across references), but compute the
            # memoized batch itself through the mesh when it lowers
            memo = self.executor._cte_memo
            child = memo.get(id(nd.input))
            if child is None:
                child = self.try_execute(nd.input)
                if child is not None:
                    self.stats["eager_mesh_recursed"] += 1
                else:
                    child = self.executor.execute(nd.input)
                memo[id(nd.input)] = child
            return ColumnBatch(nd.out_schema, child.columns, child.num_rows)
        out = self.try_execute(nd)
        if out is not None:
            self.stats["eager_mesh_recursed"] += 1
            return out
        return self.cp._materialize_leaf(nd)

    def _shard_leaf(self, b: ColumnBatch) -> ShardedTable:
        # cache rides on the first column object (shared with the source
        # table, so it persists across query materializations; a stored
        # batch is replaced, never written in place, so a new version of
        # the table has new column objects). Keyed by the projected column
        # NAMES too: two projections of the same table (e.g. (k,v) and
        # (k,v,f) in a self-set-op) share columns[0] but need different
        # shard plane sets; and by the mesh's devices.
        key = ((self.n, b.num_rows, tuple(map(str, self.mesh.devices)))
               + tuple(b.schema.names()))
        cache = getattr(b.columns[0], "_qe_mesh_shard", None)
        if not isinstance(cache, dict):
            cache = {}
            b.columns[0]._qe_mesh_shard = cache
        st = cache.get(key)
        if st is None:
            st = ShardedTable(b, self.mesh, self.axis)
            cache[key] = st
        return st

    def _replicate_batch(self, b: ColumnBatch):
        """A subquery's batch, given whole to every shard (P())."""
        return {
            "d": [c.data for c in b.columns],
            "v": [c.validity for c in b.columns],
            "n": torch.tensor(b.num_rows, dtype=torch.int64,
                              device=self.mesh.home),
        }

    def _flat_args(self, shards, sub_args, dyn_args):
        flat: List = []
        for st in shards:
            flat.extend(st.datas)
            flat.extend(st.valids)
            flat.append(st.shard_rows)
        for a in sub_args:
            flat.extend(a["d"])
            flat.extend(a["v"])
            flat.append(a["n"])
        flat.extend(dyn_args)
        return tuple(flat)

    def _assemble(self, entry, datas, valids, sel, total, limit
                  ) -> ColumnBatch:
        """The shards' selected rows, compacted to the front on the home
        device (the count was read with the overflow: no further read)."""
        meta = entry.meta
        cap = padded_capacity(max(total, 1))
        idx = K.compaction_indices(sel, sel, cap)
        keep = torch.arange(cap, device=sel.device) < total
        cd, cv = K.gather_columns_packed(list(datas), list(valids),
                                         [None] * len(datas), idx, keep)
        cols = [Column(d, v, dt, dic) for d, v, dt, dic in
                zip(cd, cv, meta["dtypes"], meta["dicts"])]
        batch = ColumnBatch(meta["schema"], cols, total)
        if limit is not None:
            skip, fetch = limit
            batch = batch.slice(skip, total if fetch is None else fetch)
        return batch

    # ---- program construction -------------------------------------------
    def _build_fn(self, entry: _MEntry, leaves, sub_batches, shards,
                  factor: float, count_mode: bool = False):
        """The program: `spmd.shard_map` of one shard's body over the flat
        arguments (`_flat_args`). An emit program returns (datas, valids,
        sel) concatenated over the shards and the psum'd overflow; a count
        program (the max per-shard join size, the overflow)."""
        axis = self.axis
        cp = self.cp
        ev = self.executor.evaluator
        leaf_facts = [_static_facts(b) for b in leaves]
        sub_facts = [_static_facts(b) for b in sub_batches]
        n_leaf_cols = [len(b.columns) for b in leaves]
        n_sub_cols = [len(b.columns) for b in sub_batches]
        caps = [st.shard_capacity for st in shards]
        out_len = len(entry.plan.schema())
        runs = {"first": True}

        def step(*flat):
            i = 0
            my = spmd.axis_index(axis)
            dev = flat[0].device
            tables: Dict[int, _TTable] = {}
            for nd, (schema, _, types, bounds), nc, cap in zip(
                    entry.leaf_nodes, leaf_facts, n_leaf_cols, caps):
                datas = flat[i: i + nc]
                valids = flat[i + nc: i + 2 * nc]
                rows = flat[i + 2 * nc]
                i += 2 * nc + 1
                cols = [Column(d, v, dt, dic)
                        for d, v, (dt, dic) in zip(datas, valids, types)]
                tables[id(nd)] = _TTable(
                    schema, cols, K.live_mask(cap, rows[my]), cap, True,
                    list(bounds),
                )
            sub_shims = {}
            for x, (schema, scap, types, _), nc in zip(
                    entry.sub_exprs, sub_facts, n_sub_cols):
                datas = flat[i: i + nc]
                valids = flat[i + nc: i + 2 * nc]
                nrows = flat[i + 2 * nc]
                i += 2 * nc + 1
                st = _TTable(
                    schema,
                    [Column(d, v, dt, dic)
                     for d, v, (dt, dic) in zip(datas, valids, types)],
                    K.live_mask(scap, nrows), scap, True, [None] * nc,
                )
                sub_shims[id(x.plan)] = _ShimBatch(st)
            dyn = flat[i:]
            # per thread (engine/expr_eval.py, engine/pipeline.py): each
            # shard's body sees its own literals, subquery batches and
            # device; the per-compile stats count on the first run, once
            counting = runs["first"] and my == 0
            ev._dyn_literals = {
                id(e): v for e, v in zip(entry.dyn_exprs, dyn)
            }
            ev._subplans = sub_shims
            ev._shard_device = dev
            cp._compiling = counting
            cp._muted = not counting
            ov: List[torch.Tensor] = []
            try:
                t = self._mtrace(entry.plan, tables, entry.res, ov, factor)
            except _CountReady as e:
                if not count_mode:
                    raise
                # count program: the counted join surfaced its per-shard
                # output size; the emit capacity must cover the LARGEST
                # shard, so reduce with pmax (overflow still psums)
                count = e.count
                if not isinstance(count, torch.Tensor):
                    count = torch.tensor(int(count), device=dev)
                cnt = spmd.pmax(_i64(count).reshape(()), axis)
                return (cnt.reshape(1),
                        spmd.psum(self._overflow(ov, dev), axis).reshape(1))
            finally:
                ev._dyn_literals = None
                ev._subplans = None
                ev._shard_device = None
                cp._compiling = False
                cp._muted = False
                cp._leaf_ids = frozenset()
            if count_mode:
                raise _Unsupported("counted join not reached in mesh trace")
            if my == 0 and not entry.meta:
                entry.meta.update(
                    schema=t.schema,
                    dtypes=[c.dtype for c in t.cols],
                    dicts=[c.dictionary for c in t.cols],
                    capacity=t.capacity,
                )
            overflow = spmd.psum(self._overflow(ov, dev), axis)
            return (tuple(c.data for c in t.cols)
                    + tuple(c.validity for c in t.cols)
                    + (t.sel, overflow.reshape(1)))

        in_specs: List = []
        for nc in n_leaf_cols:
            in_specs += [P(axis)] * (2 * nc) + [P()]
        for nc in n_sub_cols:
            in_specs += [P()] * (2 * nc + 1)
        in_specs += [P()] * len(entry.dyn_exprs)

        if count_mode:
            # (max per-shard join output size, summed exchange overflow):
            # both replicated scalars
            out_specs = (P(), P())
        else:
            # per-shard column planes + selection mask (P(axis)) and the
            # psum'd (replicated) overflow scalar (P())
            out_specs = (P(axis),) * (2 * out_len + 1) + (P(),)
        inner = spmd.shard_map(step, mesh=self.mesh, in_specs=tuple(in_specs),
                               out_specs=out_specs)

        def fn(flat):
            out = inner(*flat)
            runs["first"] = False
            if count_mode:
                return out
            return (out[:out_len], out[out_len: 2 * out_len],
                    out[2 * out_len], out[2 * out_len + 1])

        return fn

    @staticmethod
    def _overflow(ov, dev) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for o in ov:
            total = total + o
        return total

    # ---- admission + structural key -------------------------------------
    def _mchild(self, plan, ctx):
        """Key a child subtree; unsupported subtrees become eager leaf
        boundaries (executed single-device, result sharded) — same demotion
        pattern as CompiledPipeline._child."""
        cp_checks, cp_dyn = len(ctx.checks), len(ctx.dyn_vals)
        cp_sub = len(ctx.sub_exprs)
        try:
            return self._mplan_key(plan, ctx)
        except _Unsupported:
            del ctx.checks[cp_checks:]
            del ctx.dyn_vals[cp_dyn:]
            del ctx.dyn_exprs[cp_dyn:]
            del ctx.sub_exprs[cp_sub:]
            return ("leaf",), [plan], 0, 0

    def _mplan_key(self, plan, ctx):
        """-> (body, leaf_nodes, n_compute, n_exchange). Mirrors
        CompiledPipeline._plan_key, restricted to nodes with a correct
        distributed execution (cross-shard semantics get an exchange;
        shard-local nodes reuse the single-chip tracer). Literals a program
        bakes in key it by value (`_expr_key`'s `_static_operands`)."""
        if isinstance(plan, pp.PScan):
            return ("leaf",), [plan], 0, 0
        if isinstance(plan, pp.PFilter):
            if not _expr_traceable(plan.predicate):
                raise _Unsupported("filter predicate")
            body, leaves, nc, ne = self._mchild(plan.input, ctx)
            return (
                ("filter", _expr_key(plan.predicate, ctx), body),
                leaves, nc + 1, ne,
            )
        if isinstance(plan, pp.PProjection):
            if not all(_expr_traceable(e) for e in plan.exprs):
                raise _Unsupported("projection exprs")
            body, leaves, nc, ne = self._mchild(plan.input, ctx)
            trivial = all(
                isinstance(e, lp.ColumnRef)
                or (isinstance(e, lp.AliasExpr)
                    and isinstance(e.expr, lp.ColumnRef))
                for e in plan.exprs
            )
            return (
                ("proj", tuple(_expr_key(e, ctx) for e in plan.exprs), body),
                leaves, nc if trivial else nc + 1, ne,
            )
        if isinstance(plan, pp.PSubquery):
            if plan.shared:
                # shared WITH query: executor-materialized once (leaf)
                raise _Unsupported("shared CTE (materialized once)")
            body, leaves, nc, ne = self._mchild(plan.input, ctx)
            return (
                ("subq", tuple(plan.out_schema.names()), body),
                leaves, nc, ne,
            )
        if isinstance(plan, pp.PHashJoin):
            return self._mplan_key_join(plan, ctx)
        if isinstance(plan, pp.PHashAggregate):
            return self._mplan_key_agg(plan, ctx)
        if isinstance(plan, pp.PSort):
            if not all(_expr_traceable(k.expr) for k in plan.keys):
                raise _Unsupported("sort keys")
            body, leaves, nc, ne = self._mchild(plan.input, ctx)
            return (
                ("msort", tuple(_sort_key_key(k, ctx) for k in plan.keys),
                 body),
                leaves, nc + 1, ne + 1,
            )
        if isinstance(plan, pp.PDistinct):
            on = plan.on
            if on is not None and not all(_expr_traceable(e) for e in on):
                raise _Unsupported("distinct exprs")
            body, leaves, nc, ne = self._mchild(plan.input, ctx)
            okey = None if on is None else tuple(
                _expr_key(e, ctx) for e in on
            )
            return ("mdistinct", okey, body), leaves, nc + 1, ne + 1
        if isinstance(plan, pp.PWindow):
            # window functions distribute when every spec has the SAME
            # non-empty PARTITION BY: one exchange co-locates whole
            # partitions, then the single-chip window tracer is correct
            # per shard.
            if not all(_expr_traceable(w) for w in plan.window_exprs):
                raise _Unsupported("window exprs")
            if all(not w.partition_by for w in plan.window_exprs):
                # global (no PARTITION BY) windows distribute in
                # patchable families (_gw_kind / _mtrace_global_window):
                # rank functions get a cross-shard offset, prefix/whole-
                # table aggregates an all_gather'd carry, and the order-
                # sensitive families (LAG/LEAD, bounded ROWS frames,
                # NTILE, FIRST/LAST_VALUE) boundary halos — the latter
                # only over order-pristine inputs where the mesh row
                # order provably matches the single-device engine's.
                self._global_window_admission(plan, ctx)
                body, leaves, nc, ne = self._mchild(plan.input, ctx)
                return (
                    (
                        "mgwindow",
                        tuple(_expr_key(w, ctx) for w in plan.window_exprs),
                        tuple(plan.names),
                        body,
                    ),
                    leaves, nc + 1, ne + 1,
                )
            part_keys = None
            for w in plan.window_exprs:
                if not w.partition_by:
                    raise _Unsupported("mixed global/partitioned windows")
                pk = tuple(_expr_key(p) for p in w.partition_by)
                if part_keys is None:
                    part_keys = pk
                elif pk != part_keys:
                    raise _Unsupported("mixed window partitions")
            body, leaves, nc, ne = self._mchild(plan.input, ctx)
            return (
                (
                    "mwindow",
                    tuple(_expr_key(w, ctx) for w in plan.window_exprs),
                    tuple(plan.names),
                    body,
                ),
                leaves, nc + 1, ne + 1,
            )
        if isinstance(plan, pp.PSetOp):
            lbody, lleaves, ln, lne = self._mchild(plan.left, ctx)
            rbody, rleaves, rn, rne = self._mchild(plan.right, ctx)
            # UNION [ALL] concatenates per shard (no exchange; the
            # Distinct the planner adds above UNION exchanges anyway);
            # INTERSECT/EXCEPT exchange both sides by full-row hash
            extra = 0 if plan.kind in (
                lp.SetOpKind.UNION, lp.SetOpKind.UNION_ALL
            ) else 2
            return (
                ("msetop", plan.kind.value, lbody, rbody),
                lleaves + rleaves, ln + rn + 1, lne + rne + extra,
            )
        # PLimit (inner) / PIndexScan / PValues / ...: no distributed
        # lowering — the enclosing _mchild makes the subtree an eager
        # leaf, so the rest of the plan still runs SPMD
        raise _Unsupported(type(plan).__name__)

    def _mplan_key_join(self, plan: pp.PHashJoin, ctx):
        if plan.join_type is lp.JoinType.CROSS or not plan.key_pairs:
            raise _Unsupported("cross join")
        for le, re_ in plan.key_pairs:
            if not (_expr_traceable(le) and _expr_traceable(re_)):
                raise _Unsupported("join key exprs")
        if plan.residual is not None and not _expr_traceable(plan.residual):
            raise _Unsupported("join residual")
        # outer joins with residual ON lower too: the exchange co-locates
        # all rows of a key, so the tracer's residual-aware padding is
        # shard-locally correct (TPC-H Q13's LEFT JOIN ... AND NOT LIKE)
        lprov = self.cp._unique_prov_multi(
            plan.left, [le for le, _ in plan.key_pairs], ctx
        )
        rprov = self.cp._unique_prov_multi(
            plan.right, [re_ for _, re_ in plan.key_pairs], ctx
        )
        if lprov is None and rprov is None:
            raise _Unsupported("no statically bounded join side")
        lbody, lleaves, ln, lne = self._mchild(plan.left, ctx)
        rbody, rleaves, rn, rne = self._mchild(plan.right, ctx)
        ctx.checks.append((plan, lprov, rprov))
        body = (
            "mjoin", plan.join_type.value,
            tuple(
                (_expr_key(le, ctx), _expr_key(re_, ctx))
                for le, re_ in plan.key_pairs
            ),
            None if plan.residual is None else _expr_key(plan.residual, ctx),
            tuple(plan.out_schema.names()),
            lbody, rbody,
        )
        return body, lleaves + rleaves, ln + rn + 1, lne + rne + 2

    def _mplan_key_agg(self, plan: pp.PHashAggregate, ctx):
        if plan.mode != "single":
            raise _Unsupported("non-single aggregate mode")
        if any(a.func in lp.ORDERED_SET_FNS
               or a.func in (lp.AggFunc.STRING_AGG, lp.AggFunc.ARRAY_AGG)
               for a in plan.agg_exprs):
            raise _Unsupported("percentile aggregate")  # eager leaf
        exprs = list(plan.group_exprs) + [
            a.expr for a in plan.agg_exprs if a.expr is not None
        ]
        if not all(_expr_traceable(e) for e in exprs):
            raise _Unsupported("aggregate exprs")
        if not plan.group_exprs:
            # global aggregate: partial-per-shard + all_gather combine;
            # needs a partial decomposition for every aggregate
            for a in plan.agg_exprs:
                if a.distinct:
                    raise _Unsupported("global DISTINCT aggregate")
                if a.expr is None:
                    continue  # COUNT(*)
                if a.func not in _GLOBAL_PARTIAL:
                    raise _Unsupported(f"global {a.func}")
                if a.expr.dtype.kind.name == "DECIMAL128":
                    raise _Unsupported("global decimal aggregate")
        body, leaves, nc, ne = self._mchild(plan.input, ctx)
        return (
            (
                "magg",
                tuple(_expr_key(g, ctx) for g in plan.group_exprs),
                tuple(
                    (a.func.value, a.distinct,
                     None if a.expr is None else _expr_key(a.expr, ctx))
                    for a in plan.agg_exprs
                ),
                tuple(plan.schema().names()),
                body,
            ),
            leaves, nc + 1, ne + 1,
        )

    # ---- in-program tracing ----------------------------------------------
    def _local(self, plan, kids, ins, res) -> _TTable:
        """The single-chip tracer over `plan` with its inputs `kids`
        already traced (`ins`) as the segment's leaves."""
        leaf_ids = frozenset(map(id, kids))
        self.cp._leaf_ids = leaf_ids  # this thread's (`_fd_dependent_keys`)
        return self.cp._trace(plan, iter(ins), leaf_ids, res)

    def _mtrace(self, plan, tables, res, ov, factor) -> _TTable:
        """Build the per-shard table for `plan` inside shard_map.

        Local nodes delegate to CompiledPipeline._trace with the child
        pre-traced as a leaf; exchange-bearing nodes first repartition via
        all_to_all so the local kernels see co-located data.
        """
        if id(plan) in tables:
            return tables[id(plan)]
        if isinstance(plan, (pp.PFilter, pp.PProjection, pp.PSubquery)):
            t = self._mtrace(plan.input, tables, res, ov, factor)
            return self._local(plan, [plan.input], [t], res)
        if isinstance(plan, pp.PHashJoin):
            return self._mtrace_join(plan, tables, res, ov, factor)
        if isinstance(plan, pp.PHashAggregate):
            return self._mtrace_aggregate(plan, tables, res, ov, factor)
        if isinstance(plan, pp.PSort):
            return self._mtrace_sort(plan, tables, res, ov, factor)
        if isinstance(plan, pp.PWindow):
            if not plan.window_exprs[0].partition_by:
                return self._mtrace_global_window(plan, tables, res, ov,
                                                  factor)
            t = self._mtrace(plan.input, tables, res, ov, factor)
            ev = self.executor.evaluator
            pvals = [
                ev.eval(p, _ShimBatch(t))
                for p in plan.window_exprs[0].partition_by
            ]
            pid = spmd.combined_partition_ids(
                [v.data for v in pvals], [v.validity for v in pvals],
                self.n,
            )
            t2 = self._exchange(t, pid, ov, factor)
            return self._local(plan, [plan.input], [t2], res)
        if isinstance(plan, pp.PSetOp):
            lt = self._mtrace(plan.left, tables, res, ov, factor)
            rt = self._mtrace(plan.right, tables, res, ov, factor)
            if plan.kind in (lp.SetOpKind.UNION, lp.SetOpKind.UNION_ALL):
                # per-shard concatenation IS the distributed union
                return self._local(plan, [plan.left, plan.right], [lt, rt],
                                   res)
            # INTERSECT/EXCEPT: co-locate equal rows (NULLs compare equal
            # here, but combined_partition_ids routes NULL-containing
            # rows consistently on both sides, so membership is local)
            lpid = spmd.combined_partition_ids(
                [c.data for c in lt.cols],
                [c.validity for c in lt.cols], self.n,
            )
            rpid = spmd.combined_partition_ids(
                [c.data for c in rt.cols],
                [c.validity for c in rt.cols], self.n,
            )
            lt2 = self._exchange(lt, lpid, ov, factor)
            rt2 = self._exchange(rt, rpid, ov, factor)
            return self._local(plan, [plan.left, plan.right], [lt2, rt2],
                               res)
        if isinstance(plan, pp.PDistinct):
            t = self._mtrace(plan.input, tables, res, ov, factor)
            ev = self.executor.evaluator
            if plan.on is not None:
                kvals = [ev.eval(e, _ShimBatch(t)) for e in plan.on]
                kd = [v.data for v in kvals]
                kv = [v.validity for v in kvals]
            else:
                kd = [c.data for c in t.cols]
                kv = [c.validity for c in t.cols]
            pid = spmd.combined_partition_ids(kd, kv, self.n)
            t2 = self._exchange(t, pid, ov, factor)
            return self._local(plan, [plan.input], [t2], res)
        raise _Unsupported(type(plan).__name__)

    def _mtrace_join(self, plan, tables, res, ov, factor) -> _TTable:
        ev = self.executor.evaluator
        lt = self._mtrace(plan.left, tables, res, ov, factor)
        rt = self._mtrace(plan.right, tables, res, ov, factor)
        lkd, lkv, rkd, rkv = [], [], [], []
        for le, re_ in plan.key_pairs:
            lv = ev.eval(le, _ShimBatch(lt))
            rv = ev.eval(re_, _ShimBatch(rt))
            if lv.dictionary is not None or rv.dictionary is not None:
                # hash UNIFIED codes so both sides route value-consistently
                lv, rv = unify_dicts(lv, rv)
            lkd.append(lv.data)
            lkv.append(lv.validity)
            rkd.append(rv.data)
            rkv.append(rv.validity)
        lpid = spmd.combined_partition_ids(lkd, lkv, self.n)
        rpid = spmd.combined_partition_ids(rkd, rkv, self.n)
        lt2 = self._exchange(lt, lpid, ov, factor)
        rt2 = self._exchange(rt, rpid, ov, factor)
        return self._local(plan, [plan.left, plan.right], [lt2, rt2], res)

    def _mtrace_aggregate(self, plan, tables, res, ov, factor) -> _TTable:
        ev = self.executor.evaluator
        t = self._mtrace(plan.input, tables, res, ov, factor)
        if not plan.group_exprs:
            return self._mtrace_global_agg(plan, t)
        if self._partial_eligible(plan):
            return self._mtrace_partial_final(plan, t, res, ov, factor)
        gvals = [ev.eval(g, _ShimBatch(t)) for g in plan.group_exprs]
        pid = spmd.combined_partition_ids(
            [v.data for v in gvals], [v.validity for v in gvals], self.n
        )
        t2 = self._exchange(t, pid, ov, factor)
        # groups are now co-located: the single-chip grouped aggregate is
        # correct per shard, and shards hold disjoint group sets
        return self._local(plan, [plan.input], [t2], res)

    @staticmethod
    def _partial_eligible(plan) -> bool:
        return partial_eligible(plan)

    @staticmethod
    def _partial_final_plans(plan):
        return build_partial_final(plan)

    def _mtrace_partial_final(self, plan, t, res, ov, factor) -> _TTable:
        """Grouped aggregate as partial -> all_to_all of partial GROUPS ->
        final combine: the exchange moves per-shard groups, not rows."""
        partial, final, proj = self._partial_final_plans(plan)
        if self.cp._compiling:  # once per compile (shard 0's first run)
            self.stats["agg_partial_final"] += 1
        pt = self._local(partial, [plan.input], [t], res)
        k = len(plan.group_exprs)
        pid = spmd.combined_partition_ids(
            [c.data for c in pt.cols[:k]],
            [c.validity for c in pt.cols[:k]], self.n,
        )
        pt2 = self._exchange(pt, pid, ov, factor)
        ft = self._local(final, [partial], [pt2], res)
        return self._local(proj, [final], [ft], res)

    def _mtrace_global_agg(self, plan, t: _TTable) -> _TTable:
        """No GROUP BY: per-shard partials -> all_gather -> combine.

        Every shard computes the combined result (replicated), but only
        shard 0 marks its row live so the gather yields one row —
        semantics parity with the single-chip global aggregate (reference
        operators.rs:745-848: COUNT counts rows, SUM/MIN/MAX NULL on empty).
        """
        ev = self.executor.evaluator
        shim = _ShimBatch(t)
        cap = t.capacity
        dev = t.sel.device
        my = spmd.axis_index(self.axis)
        n = self.n
        schema = plan.schema()
        S = 128
        cols: List[Column] = []
        zeros = torch.zeros(cap, dtype=torch.int64, device=dev)
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        for agg, f in zip(plan.agg_exprs, schema):
            if agg.expr is None:
                # COUNT(*): local count -> sum across shards
                lc, _ = K.global_aggregate("count_star", zeros, ones,
                                           t.sel, S)
                parts = spmd.all_gather(lc[:1], self.axis).reshape(n)
                out_d = _slot0(parts.sum(), S)
                out_v = torch.ones(S, dtype=torch.bool, device=dev)
                cols.append(Column(out_d, out_v, f.data_type, None))
                continue
            av = ev.eval(agg.expr, shim)
            pfuncs, cfuncs = _GLOBAL_PARTIAL[agg.func]
            combined = []
            for pf, cf in zip(pfuncs, cfuncs):
                pv, pok = K.global_aggregate(pf, av.data, av.validity,
                                             t.sel, S)
                parts = spmd.all_gather(pv[:1], self.axis).reshape(n)
                pvalid = spmd.all_gather(pok[:1], self.axis).reshape(n)
                cv, cok = K.segment_aggregate(
                    cf, parts, pvalid,
                    torch.zeros(n, dtype=torch.int64, device=dev), n, 1,
                )
                combined.append((cv[0], cok[0]))
            val, ok = combined[0]
            if agg.func is lp.AggFunc.AVG:
                csum, _ = combined[1]
                val = val.to(torch.float64) / csum.clamp(min=1).to(
                    torch.float64)
            out_d = _slot0(val, S)
            out_v = _slot0(ok, S)
            out_dict = (
                av.dictionary
                if agg.func in (lp.AggFunc.MIN, lp.AggFunc.MAX)
                and av.dictionary is not None
                else None
            )
            if out_dict is not None:
                out_d = out_d.to(torch.int32)
            cols.append(Column(out_d, out_v, f.data_type, out_dict))
        sel = torch.arange(S, device=dev) < (1 if my == 0 else 0)
        return _TTable(schema, cols, sel, S, False, [None] * len(cols))

    def _range_pid(self, t: _TTable, k0):
        """Sampled range-partition ids for `t` on sort key `k0`: same-key
        rows always get the same id (searchsorted against fixed pivots), so
        key ties co-locate after the exchange."""
        ev = self.executor.evaluator
        v = ev.eval(k0.expr, _ShimBatch(t))
        okey = K.orderable_i64(v.data)
        # the reference's promotion: float64 keys stay float64, the
        # integer images widen to int64
        if not okey.is_floating_point():
            okey = _i64(okey)
        if not k0.asc:
            okey = -1 - okey  # order-reversing, overflow-free
        nf = k0.resolved_nulls_first()
        lo = float(_I64_MIN) if okey.is_floating_point() else _I64_MIN
        hi = float(_I64_MAX) if okey.is_floating_point() else _I64_MAX
        okey = torch.where(v.validity, okey, lo if nf else hi)
        cap = t.capacity
        live = t.sel
        # dead rows ride at +inf so they fall out of the pivot quantiles
        skey = torch.where(live, okey, hi)
        # stride-sample the UNSORTED planes (no local pre-sort): positions
        # are arbitrary wrt key order, so this is a systematic ~ random
        # sample of the live rows; dead samples ride at +inf and are
        # counted out of the quantiles below. s >= 512*n keeps the relative
        # shard-width error 2.5*sqrt(n/s) within the 1.125 base factor
        # (spmd.sort_samples_for math)
        ns = min(cap, 512 * self.n)
        pos = (torch.arange(ns, dtype=torch.int64, device=skey.device)
               * cap) // ns
        samples = skey[pos]
        sval = live[pos]
        allsamp = torch.sort(
            spmd.all_gather(samples, self.axis).reshape(-1)).values
        m = _i64(spmd.all_gather(sval, self.axis)).sum()
        # n-1 pivots at even quantiles of the VALID samples (valid ones
        # sort to the front; +inf sentinels cluster past index m-1)
        bidx = (torch.arange(1, self.n, dtype=torch.int64,
                             device=skey.device) * m) // self.n
        pivots = allsamp[bidx.clamp(0, allsamp.shape[0] - 1)]
        return torch.searchsorted(pivots, skey, right=True).to(torch.int32)

    def _mtrace_sort(self, plan, tables, res, ov, factor) -> _TTable:
        """Global sort: sampled range partition on the primary key (ties
        co-locate, so secondary keys resolve locally), then the single-chip
        sort per shard. Shard-order concatenation is the global ORDER BY
        (sorted-merge parity, reference operators.rs:141-194)."""
        t = self._mtrace(plan.input, tables, res, ov, factor)
        pid = self._range_pid(t, plan.keys[0])
        t2 = self._exchange(t, pid, ov, factor)
        return self._local(plan, [plan.input], [t2], res)

    _G_RANK_FNS = (lp.WindowFn.ROW_NUMBER, lp.WindowFn.RANK,
                   lp.WindowFn.DENSE_RANK)
    _G_AGG_FNS = (lp.WindowFn.SUM, lp.WindowFn.COUNT, lp.WindowFn.MIN,
                  lp.WindowFn.MAX, lp.WindowFn.AVG)
    # patch families whose value depends on the exact total row order
    # (not just key order): they are admitted only over an order-pristine
    # input, where the post-exchange per-shard slot order provably equals
    # the single-device engine's row order (see _order_pristine)
    _GW_ORDER_SENSITIVE = frozenset({
        "ntile", "lag", "lead", "first", "last_peer", "last_global",
        "aggrows",
    })

    def _gw_kind(self, w):
        """Classify a global (no PARTITION BY) window spec into its mesh
        patch family, or raise _Unsupported. Families:

        - ("rank",)         ROW_NUMBER/RANK/DENSE_RANK: + prior-shard offset
        - ("rank_dist",)    PERCENT_RANK/CUME_DIST: from the global rank /
                            last-peer position + the broadcast total count
        - ("ntile",)        recomputed from global rank + total count
        - ("lag", k) / ("lead", k)  boundary-halo value from the adjacent
                            shards (k = static offset)
        - ("first",)        global first row's value, broadcast
        - ("last_peer",)    last tie peer — fully local after the exchange
        - ("last_global",)  global last row's value, broadcast
        - ("agg_prefix",)   SUM/COUNT/MIN/MAX over RANGE UNBOUNDED
                            PRECEDING..CURRENT: + whole-prior-shard carry
        - ("agg_whole",)    aggregate over the whole table: all-shard
                            combine, broadcast
        - ("aggrows", s, e) SUM/COUNT/MIN/MAX over a ROWS frame: edge rows
                            patch with halo suffix/prefix aggregates;
                            unbounded sides add whole-shard carries
        """
        fn = w.func
        if fn in self._G_RANK_FNS:
            if not w.order_by:
                raise _Unsupported("global rank window order")
            return ("rank",)
        if fn in (lp.WindowFn.PERCENT_RANK, lp.WindowFn.CUME_DIST):
            # ties co-locate after the range exchange, so peer boundaries
            # are local
            if not w.order_by:
                raise _Unsupported("global rank-dist window order")
            return ("rank_dist",)
        if fn is lp.WindowFn.NTILE:
            if not w.order_by:
                raise _Unsupported("global NTILE order")
            if not (w.args and isinstance(w.args[0], lp.Literal)):
                raise _Unsupported("global NTILE tiles")
            return ("ntile",)
        if fn in (lp.WindowFn.LAG, lp.WindowFn.LEAD):
            if not w.order_by:
                raise _Unsupported("global LAG/LEAD order")
            k = 1
            if len(w.args) > 1:
                if not isinstance(w.args[1], lp.Literal):
                    raise _Unsupported("global LAG/LEAD offset")
                k = W.const_int(w.args[1], 1)
            if k < 0:
                raise _Unsupported("negative LAG/LEAD offset")
            return ("lag" if fn is lp.WindowFn.LAG else "lead", k)
        if fn in (lp.WindowFn.FIRST_VALUE, lp.WindowFn.LAST_VALUE):
            if not w.order_by:
                raise _Unsupported("global FIRST/LAST_VALUE order")
            try:
                fdesc = W.classify_window_frame(w.frame, bool(w.order_by))
            except ExecutionError:
                raise _Unsupported("global window frame")
            if fn is lp.WindowFn.FIRST_VALUE:
                if fdesc in (("partition",), ("range_current",)) or (
                    fdesc[0] == "rows" and fdesc[1] is None
                ):
                    return ("first",)
                raise _Unsupported("global FIRST_VALUE frame")
            # LAST_VALUE: only the partition-end and last-tie-peer frames
            # have mesh patches; bounded frame ends (positions near shard
            # tails would need halos) fall back wholesale
            if fdesc == ("partition",) or (
                fdesc[0] == "rows" and fdesc[1] is None and fdesc[2] is None
            ):
                return ("last_global",)
            if fdesc == ("range_current",):
                return ("last_peer",)
            raise _Unsupported("global LAST_VALUE frame")
        if fn in self._G_AGG_FNS:
            if w.args and w.args[0].dtype.kind.name not in _GW_ARG_KINDS:
                raise _Unsupported("global window agg arg type")
            try:
                fdesc = W.classify_window_frame(w.frame, bool(w.order_by))
            except ExecutionError:
                raise _Unsupported("global window frame")
            if fdesc[0] == "range_off":
                # value-distance frames can straddle shard boundaries by
                # arbitrary amounts — no halo bound; fall back wholesale
                raise _Unsupported("global RANGE offset frame")
            if fdesc == ("partition",):
                return ("agg_whole",)
            if fdesc == ("range_current",):
                if w.order_by and fn is not lp.WindowFn.AVG:
                    return ("agg_prefix",)
                raise _Unsupported("global window frame")
            # ("rows", s, e): s in {None, int>=0}, e in {None, int>=0}
            s_off, e_off = fdesc[1], fdesc[2]
            if s_off is None and e_off is None:
                return ("agg_whole",)  # whole partition, order-free
            if fn is lp.WindowFn.AVG:
                raise _Unsupported("global AVG rows frame")
            if not w.order_by:
                raise _Unsupported("global rows frame order")
            return ("aggrows", s_off, e_off)
        raise _Unsupported("global window fn")

    def _global_window_admission(self, plan, ctx):
        """Raise _Unsupported unless every global spec has a patch family
        (_gw_kind). All order-bearing non-whole-table specs must share the
        first ORDER BY key (one exchange co-locates everyone's ties), and
        order-sensitive families additionally require an order-pristine
        input subtree (scan/filter/projection only), where the mesh row
        order provably matches the single-device engine's."""
        fkey = None
        sensitive = False
        for w in plan.window_exprs:
            kind = self._gw_kind(w)
            if kind[0] in self._GW_ORDER_SENSITIVE:
                sensitive = True
            if kind[0] != "agg_whole" and w.order_by:
                kk = _sort_key_key(w.order_by[0], ctx)
                if fkey is None:
                    fkey = kk
                elif kk != fkey:
                    raise _Unsupported("mixed global window order")
        if sensitive and not _order_pristine(plan.input):
            raise _Unsupported("order-sensitive global window input")

    def _mtrace_global_window(self, plan, tables, res, ov, factor) -> _TTable:
        """Global (no PARTITION BY) windows: range-exchange on the shared
        first ORDER BY key (ties co-locate; skipped when every spec is a
        whole-table aggregate), run the single-chip window tracer per
        shard, then patch each window column with an all_gather'd
        cross-shard term:

        - ROW_NUMBER/RANK: + prior shards' live-row count (ties never
          span shards, so local rank boundaries are exact).
        - DENSE_RANK: + prior shards' distinct-key count (= max local
          dense rank).
        - SUM/COUNT/MIN/MAX over RANGE UNBOUNDED PRECEDING..CURRENT:
          combine with the carry aggregate of ALL rows on prior shards
          (at any row, the global prefix = local prefix + whole prior
          shards — tie peers are local).
        - SUM/COUNT/MIN/MAX/AVG over the whole table: replace with the
          all-shard combine, broadcast.

        Order-sensitive families (_GW_ORDER_SENSITIVE: LAG/LEAD, bounded
        ROWS frames, NTILE, FIRST/LAST_VALUE) patch with boundary HALOS:
        each shard all_gathers its first/last k live sorted rows' values,
        builds the k rows globally adjacent to its own range, and fixes its
        edge rows — O(n_devices x k) scalars, never a second data exchange.
        Admitted only over order-pristine inputs (_order_pristine), where
        per-shard slot order provably equals the single-device row order,
        so results stay identical to the single-chip engine's."""
        ev = self.executor.evaluator
        t = self._mtrace(plan.input, tables, res, ov, factor)
        kinds = [self._gw_kind(w) for w in plan.window_exprs]
        needs_exchange = any(k[0] != "agg_whole" for k in kinds)
        if needs_exchange:
            k0 = next(
                w.order_by[0] for w in plan.window_exprs if w.order_by
            )
            pid = self._range_pid(t, k0)
            t2 = self._exchange(t, pid, ov, factor)
        else:
            t2 = t
        wt = self._local(plan, [plan.input], [t2], res)
        n = self.n
        my = spmd.axis_index(self.axis)
        dev = wt.sel.device
        sidx = torch.arange(n, dtype=torch.int64, device=dev)
        prior = sidx < my
        following = sidx > my
        live = wt.sel
        cnt = _i64(live).sum()
        counts = spmd.all_gather(cnt.reshape(1), self.axis).reshape(n)
        prior_rows = torch.where(prior, counts, 0).sum()

        def gathered(x):
            return spmd.all_gather(x.reshape(1), self.axis).reshape(n)

        cap2 = t2.capacity
        rank_cache: Dict[tuple, tuple] = {}

        def local_rank(w):
            """(perm, pos): stable sort permutation over this spec's FULL
            ORDER BY and each slot's 0-based local sorted rank. Cached per
            distinct key tuple across specs."""
            key = tuple(
                (str(_expr_key(k.expr)), k.asc, k.resolved_nulls_first())
                for k in w.order_by
            )
            hit = rank_cache.get(key)
            if hit is None:
                o_vals = [ev.eval(k.expr, _ShimBatch(t2)) for k in w.order_by]
                perm = K.sort_permutation(
                    [v.data for v in o_vals],
                    [v.validity for v in o_vals],
                    [k.asc for k in w.order_by],
                    [k.resolved_nulls_first() for k in w.order_by],
                    t2.sel,
                )
                pos = torch.empty_like(perm)
                pos[perm] = torch.arange(cap2, dtype=perm.dtype, device=dev)
                hit = (perm, pos)
                rank_cache[key] = hit
            return hit

        def shard_edge(perm, m, planes, head):
            """This shard's first (head) / last m live sorted rows: each
            plane gathered at those rows, plus an exists mask."""
            if head:
                sp = torch.arange(m, dtype=torch.int64, device=dev)
                exists = sp < cnt
            else:
                sp = cnt - m + torch.arange(m, dtype=torch.int64, device=dev)
                exists = sp >= 0
            rows = perm[sp.clamp(0, cap2 - 1)]
            return [p[rows] for p in planes], exists

        def global_edge(vals, oks, exists, m, head):
            """The m rows globally adjacent to this shard's range (just
            before when head=False, just after when head=True), in global
            sorted order, as (vals, oks, exists) of length m. Built from
            one all_gather of every shard's edge (n x m scalars)."""
            side = following if head else prior
            gex = (spmd.all_gather(exists, self.axis)
                   & side[:, None]).reshape(-1)
            gv = spmd.all_gather(vals, self.axis).reshape(-1)
            gok = spmd.all_gather(oks, self.axis).reshape(-1)
            if head:
                rk = torch.cumsum(gex.to(torch.int32), 0)
                dest = torch.where(gex & (rk <= m), rk - 1, m)
            else:
                rk = torch.cumsum(gex.flip(0).to(torch.int32), 0).flip(0)
                dest = torch.where(gex & (rk <= m), m - rk, m)
            dest = _i64(dest)
            pick = dest < m
            ovals = torch.zeros(m + 1, dtype=gv.dtype, device=dev)
            ovals[dest] = torch.where(pick, gv, torch.zeros((), dtype=gv.dtype,
                                                            device=dev))
            ook = torch.zeros(m + 1, dtype=torch.bool, device=dev)
            ook[dest] = pick & gok
            oex = torch.zeros(m + 1, dtype=torch.bool, device=dev)
            oex[dest] = pick
            return ovals[:m], ook[:m], oex[:m]

        def merge_agg(cur, cok, add_v, add_ok, mask, comb):
            """Combine a patch contribution into (cur, cok) on `mask` rows
            (NULL-aware: either side alone passes through)."""
            add_v = add_v.to(cur.dtype).expand(cur.shape)
            add_ok = add_ok.expand(cok.shape)
            both = cok & add_ok
            nv = torch.where(both, comb(cur, add_v),
                             torch.where(add_ok, add_v, cur))
            m2 = mask & live
            return (torch.where(m2, nv, cur),
                    torch.where(m2, cok | add_ok, cok))

        n_in = len(plan.input.schema())
        new_cols = list(wt.cols)
        for j, (w, kind) in enumerate(zip(plan.window_exprs, kinds)):
            ci = n_in + j
            col = wt.cols[ci]
            if kind == ("rank",):  # rank family
                if w.func is lp.WindowFn.DENSE_RANK:
                    local_d = _i64(torch.where(live, col.data, 0)).max()
                    add = torch.where(prior, gathered(local_d), 0).sum()
                else:
                    add = prior_rows
                nd = torch.where(live, col.data + add, col.data)
                new_cols[ci] = Column(nd, col.validity, col.dtype,
                                      col.dictionary)
                continue
            if kind[0] == "last_peer":
                # last tie peer: ties co-locate after the exchange, so the
                # local tracer's answer is already globally correct
                continue
            if kind == ("rank_dist",):
                # PERCENT_RANK = (global_rank - 1)/(T - 1); CUME_DIST =
                # global last-peer position / T. Peer boundaries are local
                # (ties co-locate), so recompute rank/peer-end in the local
                # sorted space and add the prior-shard row offset.
                perm, pos = local_rank(w)
                o_vals = [ev.eval(k.expr, _ShimBatch(t2))
                          for k in w.order_by]
                order_sorted = []
                for v in o_vals:
                    kk, nn = K.normalize_key(v.data[perm], v.validity[perm])
                    order_sorted += [nn.to(torch.int32), kk]
                pad_sorted = torch.arange(cap2, device=dev) >= cnt
                seg_change, peer_change, _seg = K.window_segments(
                    [], order_sorted, pad_sorted
                )
                rank_s = K.rank_sorted(seg_change, peer_change)
                pe_s = _i64(K._seg_end_pos(peer_change))
                grank = rank_s[pos] + prior_rows
                gpeer = pe_s[pos] + prior_rows
                total = counts.sum()
                if w.func is lp.WindowFn.PERCENT_RANK:
                    nd = torch.where(
                        total > 1,
                        (grank - 1).to(torch.float64)
                        / (total - 1).clamp(min=1).to(torch.float64),
                        0.0,
                    )
                else:
                    nd = (gpeer + 1).to(torch.float64) / total.clamp(
                        min=1).to(torch.float64)
                new_cols[ci] = Column(nd, col.validity, col.dtype, None)
                continue
            if kind == ("ntile",):
                # recompute from the global rank and total count (PG
                # semantics: q=T//n, r=T%n, first r tiles get q+1 rows —
                # kernels.ntile_sorted parity)
                m_tiles = max(W.const_int(w.args[0], 1), 1)
                _perm, pos = local_rank(w)
                rg = _i64(pos) + prior_rows
                total = counts.sum()
                q = total // m_tiles
                rem = total % m_tiles
                big = rem * (q + 1)
                tile = torch.where(
                    rg < big,
                    rg // (q + 1).clamp(min=1),
                    rem + torch.where(q > 0, (rg - big) // q.clamp(min=1),
                                      0),
                ) + 1
                nd = torch.where(live, tile.to(col.data.dtype), col.data)
                new_cols[ci] = Column(nd, col.validity, col.dtype,
                                      col.dictionary)
                continue
            if kind[0] in ("lag", "lead"):
                koff = kind[1]
                if koff == 0:
                    continue  # offset 0 = the row itself; local is exact
                av = ev.eval(w.args[0], _ShimBatch(t2))
                perm, pos = local_rank(w)
                r = _i64(pos)
                head = kind[0] == "lead"
                (hd, hv), hex_ = shard_edge(
                    perm, koff, [av.data, av.validity], head=head
                )
                Gv, Gok, Gex = global_edge(hd, hv & hex_, hex_, koff, head)
                if head:
                    off = r + koff - cnt
                    need = live & (off >= 0)
                    idxs = off.clamp(0, koff - 1)
                else:
                    need = live & (r < koff)
                    idxs = r.clamp(0, koff - 1)
                pv = Gv[idxs].to(col.data.dtype)
                pok, pex = Gok[idxs], Gex[idxs]
                if len(w.args) > 2:  # default when the target is off-table
                    dv = ev.eval(w.args[2], _ShimBatch(t2))
                    pv = torch.where(pex, pv, dv.data.to(col.data.dtype))
                    pok = torch.where(pex, pok, dv.validity)
                nd = torch.where(need, pv, col.data)
                nv = torch.where(need, pok, col.validity)
                new_cols[ci] = Column(nd, nv, col.dtype, col.dictionary)
                continue
            if kind[0] in ("first", "last_global"):
                av = ev.eval(w.args[0], _ShimBatch(t2))
                perm, _pos = local_rank(w)
                has = cnt > 0
                if kind[0] == "first":
                    row = perm[0]
                else:
                    row = perm[(cnt - 1).clamp(0, cap2 - 1)]
                lv = av.data[row]
                lok = av.validity[row] & has
                Gv, Gok, Ghas = gathered(lv), gathered(lok), gathered(has)
                if kind[0] == "first":
                    pickix = torch.argmin(torch.where(Ghas, sidx, n))
                else:
                    pickix = torch.argmax(torch.where(Ghas, sidx, -1))
                val = Gv[pickix].to(col.data.dtype)
                ok = Gok[pickix] & Ghas.any()
                nd = torch.where(live, val, col.data)
                nv = torch.where(live, ok, col.validity)
                new_cols[ci] = Column(nd, nv, col.dtype, col.dictionary)
                continue
            if kind[0] == "aggrows":
                new_cols[ci] = self._gw_rows_patch(
                    w, kind, col, t2, live, cnt, prior, following, gathered,
                    local_rank, shard_edge, global_edge, merge_agg,
                )
                continue
            # agg_prefix / agg_whole: local whole-shard reduction of the
            # arg, then the carry combine (prior shards for prefix frames,
            # all shards for whole-table frames)
            prefix = kind == ("agg_prefix",)
            mask = prior if prefix else torch.ones(n, dtype=torch.bool,
                                                   device=dev)
            if w.args:
                av = ev.eval(w.args[0], _ShimBatch(t2))
                if av.dictionary is not None:
                    raise _Unsupported("dictionary global window agg")
                aok = av.validity & t2.sel
                adata = av.data
            else:  # COUNT(*)
                aok = t2.sel
                adata = None
            if w.func is lp.WindowFn.COUNT:
                lval = _i64(aok).sum()
                carry = torch.where(mask, gathered(lval), 0).sum()
                if prefix:
                    nd = torch.where(live, col.data + carry, col.data)
                else:
                    nd = torch.where(live, carry, col.data)
                nv = col.validity
            elif w.func is lp.WindowFn.AVG:  # whole-table only
                s = torch.where(aok, adata, 0).to(torch.float64).sum()
                c = _i64(aok).sum()
                ts_ = torch.where(mask, gathered(s), 0.0).sum()
                tc = torch.where(mask, gathered(c), 0).sum()
                ok = tc > 0
                val = ts_ / tc.clamp(min=1).to(torch.float64)
                nd = torch.where(live, val.to(col.data.dtype), col.data)
                nv = torch.where(live, ok, col.validity)
            else:  # SUM / MIN / MAX
                dt = col.data.dtype
                if w.func is lp.WindowFn.SUM:
                    lval = torch.where(aok, adata, 0).to(dt).sum()
                    comb = torch.add
                    ident = torch.zeros((), dtype=dt, device=dev)
                else:
                    ident, red, comb = self._extreme(w.func, dt, dev)
                    lval = red(torch.where(aok, adata.to(dt), ident))
                lok = aok.any()
                parts = gathered(lval)
                poks = gathered(lok) & mask
                if w.func is lp.WindowFn.SUM:
                    carry = torch.where(poks, parts, 0).to(dt).sum()
                elif w.func is lp.WindowFn.MIN:
                    carry = torch.where(poks, parts, ident).min()
                else:
                    carry = torch.where(poks, parts, ident).max()
                carry_ok = poks.any()
                if prefix:
                    both = col.validity & carry_ok
                    nd = torch.where(
                        live & both, comb(col.data, carry),
                        torch.where(live & ~col.validity & carry_ok,
                                    carry, col.data),
                    )
                    nv = col.validity | (live & carry_ok)
                else:
                    nd = torch.where(live & carry_ok, carry, col.data)
                    nv = torch.where(live, carry_ok, col.validity)
            new_cols[ci] = Column(nd, nv, col.dtype, col.dictionary)
        return _TTable(wt.schema, new_cols, wt.sel, wt.capacity, wt.dense,
                       wt.bounds)

    @staticmethod
    def _extreme(func, dt, dev):
        """(identity, reduction, combine) of MIN or MAX over dtype dt."""
        if dt.is_floating_point:
            big = torch.finfo(dt).max
            small = -big
        else:
            big, small = torch.iinfo(dt).max, torch.iinfo(dt).min
        if func is lp.WindowFn.MIN:
            return (torch.tensor(big, dtype=dt, device=dev), torch.min,
                    torch.minimum)
        return (torch.tensor(small, dtype=dt, device=dev), torch.max,
                torch.maximum)

    def _gw_rows_patch(self, w, kind, col, t2, live, cnt, prior, following,
                       gathered, local_rank, shard_edge, global_edge,
                       merge_agg):
        """Patch a SUM/COUNT/MIN/MAX over a bounded ROWS frame
        (s PRECEDING .. e FOLLOWING, either side possibly unbounded) after
        the range exchange. The local tracer clamped the frame at the
        shard boundary; the missing pieces decompose exactly into:

        - s unbounded: every prior shard is fully inside the frame — add
          the whole-shard carry (mask=prior), like the prefix family.
        - e unbounded: symmetric with the following shards.
        - s = p (int): a row with local sorted rank r < p is missing frame
          rows tail[r..p-1], where tail = the p rows globally just before
          this shard — patch with a suffix aggregate of the halo.
        - e = f (int): rank r with r+f >= cnt is missing head[0..r+f-cnt],
          head = the f rows globally just after — prefix aggregate.

        Halos are one all_gather of (n_devices x p|f) scalars; the halo
        scans are 1-D (`torch.cummin`/`cummax` for MIN/MAX)."""
        ev = self.executor.evaluator
        s_off, f_off = kind[1], kind[2]
        fnm = w.func
        perm, pos = local_rank(w)
        r = _i64(pos)
        dt = col.data.dtype
        dev = col.data.device
        if w.args:
            av = ev.eval(w.args[0], _ShimBatch(t2))
            if av.dictionary is not None:
                raise _Unsupported("dictionary global window agg")
            ad, aok = av.data, av.validity & t2.sel
        else:
            ad, aok = None, t2.sel
        additive = fnm in (lp.WindowFn.SUM, lp.WindowFn.COUNT)
        if fnm is lp.WindowFn.COUNT:
            # counts combine additively: each in-frame row contributes its
            # 0/1 validity; the contribution itself is always defined
            vals = aok.to(dt)
            oks = t2.sel
            comb = torch.add
            ident = torch.zeros((), dtype=dt, device=dev)
            scan = None
        elif fnm is lp.WindowFn.SUM:
            vals, oks = ad.to(dt), aok
            comb = torch.add
            ident = torch.zeros((), dtype=dt, device=dev)
            scan = None
        else:
            vals, oks = ad.to(dt), aok
            ident, _red, comb = self._extreme(fnm, dt, dev)
            scan = torch.cummin if fnm is lp.WindowFn.MIN else torch.cummax

        def reduce(x):
            if additive:
                return x.sum()
            return x.min() if fnm is lp.WindowFn.MIN else x.max()

        cur, cok = col.data, col.validity
        all_live = torch.ones(cur.shape[0], dtype=torch.bool, device=dev)
        # unbounded sides: whole-shard carries
        for unb, side in ((s_off is None, prior), (f_off is None, following)):
            if not unb:
                continue
            lval = reduce(torch.where(oks, vals, ident))
            lok = oks.any()
            pv = gathered(lval)
            pok = gathered(lok) & side
            carry = reduce(torch.where(pok, pv, ident))
            cur, cok = merge_agg(cur, cok, carry, pok.any(), all_live, comb)
        # bounded tail: rows r < p miss the suffix of the prior halo
        if isinstance(s_off, int) and s_off > 0:
            (tv, tok), tex = shard_edge(perm, s_off, [vals, oks],
                                        head=False)
            Gv, Gok, _Gex = global_edge(tv, tok & tex, tex, s_off,
                                        head=False)
            gvals = torch.where(Gok, Gv, ident).flip(0)
            sfx = (torch.cumsum(gvals, 0).to(dt) if additive
                   else scan(gvals, 0).values).flip(0)
            sfx_ok = torch.cumsum(Gok.flip(0).to(torch.int32), 0).flip(0) > 0
            ridx = r.clamp(0, s_off - 1)
            cur, cok = merge_agg(cur, cok, sfx[ridx], sfx_ok[ridx],
                                 r < s_off, comb)
        # bounded head: rows r+f >= cnt miss the prefix of the next halo
        if isinstance(f_off, int) and f_off > 0:
            (hv, hok), hex_ = shard_edge(perm, f_off, [vals, oks],
                                         head=True)
            Gv, Gok, _Gex = global_edge(hv, hok & hex_, hex_, f_off,
                                        head=True)
            gvals = torch.where(Gok, Gv, ident)
            pfx = (torch.cumsum(gvals, 0).to(dt) if additive
                   else scan(gvals, 0).values)
            pfx_ok = torch.cumsum(Gok.to(torch.int32), 0) > 0
            mh = r + f_off - cnt
            hidx = mh.clamp(0, f_off - 1)
            cur, cok = merge_agg(cur, cok, pfx[hidx], pfx_ok[hidx],
                                 mh >= 0, comb)
        return Column(cur, cok, col.dtype, col.dictionary)

    # ---- the exchange ----------------------------------------------------
    def _exchange(self, t: _TTable, pid, ov, factor) -> _TTable:
        """Repartition a table's selected rows by `pid` via ONE all_to_all
        of every plane. Send capacity per destination is the balanced share
        x factor rounded to 128 (unbounded exchanges inflate local work
        ~Nx); dropped rows raise the overflow scalar and `try_execute` retries
        with a doubled factor."""
        n = self.n
        cap = t.capacity
        sc = spmd.send_cap(cap, n, None if factor >= n else factor)
        idx, counts = spmd.bucket_rows(pid, t.sel, n, sc)
        datas = [c.data for c in t.cols]
        valids = [c.validity for c in t.cols]
        rd, rv, rlive = spmd.exchange_columns(
            self.axis, idx, counts, datas, valids
        )
        ov.append((counts - sc).clamp(min=0).sum())
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(rd, rv, t.cols)
        ]
        return _TTable(t.schema, cols, rlive, n * sc, False, list(t.bounds))
