"""Physical plan executor.

The counterpart of `query_engine_tpu.engine.executor.QueryExecutor`, for
these nodes: scan, projection, filter, INNER, LEFT, RIGHT and FULL
equi-joins (with or without a residual ON condition), grouped and global
aggregate, sort, limit and derived tables (a subquery in FROM). Any other
node raises NotImplementedError.

As in the JAX package, every node first goes to the compiled pipeline
(engine/pipeline.py, on unless QE_COMPILED=0), which runs the largest
segment it supports as one static program; what it declines runs in the
eager walk below, which is also the pipeline's semantics oracle.

Parity surface: reference crates/query-executor/src/executor.rs:12-541 —
recursive plan walk materializing results per node.

Execution model: host-driven walk over fixed-capacity torch planes on the
executor's device. The host reads a scalar only where the next operator's
output capacity depends on the data (filter and join counts, the number of
groups, the group key range); `host_syncs` counts those reads, and the
compiled pipeline's (a result's row count, table statistics).

The grouped SUM/COUNT/AVG aggregate runs in the hand-written CUDA kernel of
ops/group_agg.py when the group ids are dense and bounded (the JAX
package's gate, executor.py:1099-1107,1398-1436 there); on a CPU device the
same call runs the kernel's plain version.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.core.schema import Field
from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, padded_capacity,
)
from query_engine_tpu_torch.engine.expr_eval import Evaluator, Val, unify_dicts
from query_engine_tpu_torch.engine.pipeline import (
    CompiledPipeline, compiled_enabled,
)
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp


def _val_to_column(v: Val, f: Field) -> Column:
    return Column(v.data, v.validity, f.data_type, v.dictionary)


def _take(
    batch: ColumnBatch,
    indices: torch.Tensor,
    count: int,
    row_valid: Optional[torch.Tensor] = None,
) -> ColumnBatch:
    """Gather of whole-batch rows into a new batch of len(indices) capacity
    (the vectorized `take` — reference partition.rs:292-316)."""
    out_d, out_v = K.gather_columns(
        [c.data for c in batch.columns], [c.validity for c in batch.columns],
        indices, row_valid,
    )
    cols = [
        Column(d, v, c.dtype, c.dictionary)
        for d, v, c in zip(out_d, out_v, batch.columns)
    ]
    return ColumnBatch(batch.schema, cols, count)


def _expr_struct_key(e: lp.LogicalExpr) -> str:
    """Rendered label for an expression — duplicate detection WITHIN one
    execution only."""
    return f"{type(e).__name__}:{e.name()}"


def _batch_nbytes(batch) -> int:
    """Device-plane footprint of a batch (data + validity)."""
    total = 0
    for c in getattr(batch, "columns", ()):
        total += c.data.nbytes + c.validity.nbytes
    return total


def ensure_device(batch: ColumnBatch, device: torch.device) -> ColumnBatch:
    """Move a batch's planes to `device` once, in place, so a source that
    loads lazily (CSV, Parquet) ships its planes once and not per query."""
    for c in batch.columns:
        if c.data.device != device:
            c.data = c.data.to(device)
        if c.validity.device != device:
            c.validity = c.validity.to(device)
    return batch


class QueryExecutor:
    """Executes physical plans against in-memory tables on one device."""

    # Direct (sort-free) grouping applies when there is a single integer or
    # dictionary group key whose value range is bounded — dictionary codes
    # always qualify; int columns qualify after a min/max host read.
    _DIRECT_GROUP_MAX_RANGE = 1 << 21

    # dense-gid bound up to which SUM/COUNT/AVG go to the group_agg kernel
    # (the JAX package's crossover; above it both packages take the
    # segment path)
    _MXU_AGG_MAX_GROUPS = 32768

    def __init__(self, device="cpu", udfs=None):
        self.device = torch.device(device)
        self.udfs = udfs
        self.evaluator = Evaluator(self.device, udfs=udfs)
        self.host_syncs = 0  # scalar/plane reads from the device, cumulative
        self.pipeline = CompiledPipeline(self)
        self._compiled = compiled_enabled()

    def _host_int(self, t: torch.Tensor) -> int:
        self.host_syncs += 1
        return int(t.item())

    def _host_list(self, t: torch.Tensor):
        """One counted read of a whole tensor (t.tolist())."""
        self.host_syncs += 1
        return t.tolist()

    # ---- entry ---------------------------------------------------------
    def execute(self, plan: pp.PhysicalPlan) -> ColumnBatch:
        from query_engine_tpu_torch.utils.profiling import GLOBAL_PROFILER

        if not GLOBAL_PROFILER.enabled:
            return self._execute_node(plan)
        name = type(plan).__name__
        name = (name[1:] if name.startswith("P") else name).lower() or "node"
        if self._compiled:
            with GLOBAL_PROFILER.op("compiled_pipeline") as rec:
                out = self.pipeline.try_execute(plan)
                if out is not None:
                    rec.rows = out.num_rows
                    rec.bytes = _batch_nbytes(out)
                    return out
                rec.rows = rec.bytes = 0  # fell through: charge the node
        with GLOBAL_PROFILER.op(name) as rec:
            out = self._execute_node(plan, _skip_compiled=True)
            rec.rows = out.num_rows
            rec.bytes = _batch_nbytes(out)
        return out

    def _execute_node(self, plan: pp.PhysicalPlan,
                      _skip_compiled: bool = False) -> ColumnBatch:
        if self._compiled and not _skip_compiled:
            out = self.pipeline.try_execute(plan)
            if out is not None:
                return out
        if isinstance(plan, pp.PScan):
            return self._exec_scan(plan)
        if isinstance(plan, pp.PProjection):
            return self._exec_projection(plan)
        if isinstance(plan, pp.PFilter):
            return self._exec_filter(plan)
        if isinstance(plan, pp.PHashJoin):
            return self._exec_join(plan)
        if isinstance(plan, pp.PHashAggregate):
            return self._exec_aggregate(plan)
        if isinstance(plan, pp.PSort):
            return self._exec_sort(plan)
        if isinstance(plan, pp.PLimit):
            return self._exec_limit(plan)
        if isinstance(plan, pp.PSubquery) and not plan.shared:
            # a derived table: its child's batch under the subquery's names
            # (a shared CTE, referenced more than once, is not in the slice)
            child = self.execute(plan.input)
            return ColumnBatch(plan.out_schema, child.columns, child.num_rows)
        raise NotImplementedError(
            f"query_engine_tpu_torch does not execute {type(plan).__name__} "
            "yet"
        )

    # ---- scan ----------------------------------------------------------
    def _exec_scan(self, plan: pp.PScan) -> ColumnBatch:
        batch = plan.source.scan()
        if plan.projection is not None:
            batch = batch.select(plan.projection)
        if len(batch.schema) != len(plan.out_schema):
            raise ExecutionError(
                f"scan schema mismatch for {plan.table_name}"
            )
        # columns are shared with the stored batch: planes move to the
        # device once per table version, not once per query
        ensure_device(batch, self.device)
        return ColumnBatch(plan.out_schema, batch.columns, batch.num_rows)

    # ---- projection / filter ------------------------------------------
    def _exec_projection(self, plan: pp.PProjection) -> ColumnBatch:
        batch = self.execute(plan.input)
        schema = plan.schema()
        cols = []
        for e, f in zip(plan.exprs, schema):
            v = self.evaluator.eval(e, batch)
            cols.append(_val_to_column(v, f))
        return ColumnBatch(schema, cols, batch.num_rows)

    def _filter_batch(self, batch: ColumnBatch, predicate) -> ColumnBatch:
        mask = self.evaluator.eval_predicate_mask(predicate, batch)
        count = self._host_int(K.filter_count(mask, batch.num_rows))
        idx = K.compaction_indices(mask, batch.num_rows,
                                   padded_capacity(count))
        return _take(batch, idx, count)

    def _exec_filter(self, plan: pp.PFilter) -> ColumnBatch:
        batch = self.execute(plan.input)
        return self._filter_batch(batch, plan.predicate)

    # ---- join ----------------------------------------------------------
    def _exec_join(self, plan: pp.PHashJoin) -> ColumnBatch:
        jt = plan.join_type
        if jt not in _EQUI_JOINS or not plan.key_pairs:
            raise NotImplementedError(
                f"query_engine_tpu_torch executes equi-joins only, not "
                f"{jt.value} join on {len(plan.key_pairs)} keys"
            )
        left = self.execute(plan.left)
        right = self.execute(plan.right)
        # pass 1: key eval + ranks + counts; the host reads the output size
        lkeys, rkeys = [], []
        for le, re_ in plan.key_pairs:
            lv = self.evaluator.eval(le, left)
            rv = self.evaluator.eval(re_, right)
            if lv.dictionary is not None or rv.dictionary is not None:
                lv, rv = unify_dicts(lv, rv)
            lkeys.append((lv.data, lv.validity))
            rkeys.append((rv.data, rv.validity))
        lr, rr = K.join_ranks(lkeys, rkeys, left.num_rows, right.num_rows)
        total_t, counts, _off, rank_start, right_by_rank, lm, rm = \
            K.join_counts(lr, rr, left.num_rows, right.num_rows)
        total = self._host_int(total_t)
        # pass 2: emit the pairs at a capacity chosen from the count
        out_cap = padded_capacity(total)
        li, ri, valid = K.join_emit_inner(
            counts, rank_start, right_by_rank, lr, total, out_cap
        )
        out = self._assemble_join(plan, left, right, li, ri, valid, valid,
                                  total)
        if jt is not lp.JoinType.INNER:
            return self._outer_join(plan, left, right, out, li, ri, lm, rm)
        if plan.residual is not None:
            out = self._filter_batch(out, plan.residual)
        return out

    def _outer_join(self, plan, left, right, pairs, li, ri, lmatched,
                    rmatched) -> ColumnBatch:
        """LEFT, RIGHT or FULL: the inner `pairs`, then each outer side's
        rows that kept no pair, NULL-padded on the other side.

        A residual ON condition (TPC-H Q13's `LEFT JOIN orders ON c_custkey
        = o_custkey AND o_comment NOT LIKE ...`) is part of the match: a pair
        counts only when the keys AND the residual hold, and an outer row
        whose every pair fails the residual still appears once (a filter
        after the join would drop it). So the pairs are filtered by the
        residual, and the rows of each side that kept a pair are found again
        with a scatter-max."""
        jt, dev = plan.join_type, self.device
        nl, nr = left.num_rows, right.num_rows
        keep = K.live_mask(pairs.capacity, pairs.num_rows, dev)
        if plan.residual is not None:
            keep = keep & self.evaluator.eval_predicate_mask(plan.residual,
                                                             pairs)
            keep_i = keep.to(torch.int32)
            lmatched = K._scatter_drop(left.capacity, torch.where(keep, li, -1),
                                       keep_i, 0, torch.int32,
                                       reduce="amax") > 0
            rmatched = K._scatter_drop(right.capacity,
                                       torch.where(keep, ri, -1), keep_i, 0,
                                       torch.int32, reduce="amax") > 0
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        extra_l_t = (~lmatched & K.live_mask(left.capacity, nl, dev)).sum() \
            if jt in _LEFT_OUTER else zero
        extra_r_t = (~rmatched & K.live_mask(right.capacity, nr, dev)).sum() \
            if jt in _RIGHT_OUTER else zero
        kept, extra_l, extra_r = self._host_list(
            torch.stack([keep.sum(), extra_l_t, extra_r_t]))
        if plan.residual is not None:
            pairs = _take(pairs, K.compaction_indices(
                keep, pairs.num_rows, padded_capacity(kept)), kept)
        blocks = [pairs]

        def padded_block(matched, n_rows, n_extra, is_left):
            ecap = padded_capacity(n_extra)
            u, _ = K.unmatched_indices(matched, n_rows, ecap)
            present = K.live_mask(ecap, n_extra, dev)
            absent = torch.zeros(ecap, dtype=torch.bool, device=dev)
            zeros = torch.zeros(ecap, dtype=u.dtype, device=dev)
            if is_left:
                return self._assemble_join(plan, left, right, u, zeros,
                                           present, absent, n_extra)
            return self._assemble_join(plan, left, right, zeros, u, absent,
                                       present, n_extra)

        if extra_l:
            blocks.append(padded_block(lmatched, nl, extra_l, True))
        if extra_r:
            blocks.append(padded_block(rmatched, nr, extra_r, False))
        return ColumnBatch.concat(blocks)

    def _assemble_join(
        self, plan, left, right, li, ri, lvalid, rvalid, num_rows
    ) -> ColumnBatch:
        gl_d, gl_v = K.gather_columns(
            [c.data for c in left.columns], [c.validity for c in left.columns],
            li, lvalid,
        )
        gr_d, gr_v = K.gather_columns(
            [c.data for c in right.columns],
            [c.validity for c in right.columns], ri, rvalid,
        )
        cols = [
            Column(d, v, c.dtype, c.dictionary)
            for d, v, c in zip(gl_d + gr_d, gl_v + gr_v,
                               list(left.columns) + list(right.columns))
        ]
        return ColumnBatch(plan.out_schema, cols, num_rows)

    # ---- aggregate -----------------------------------------------------
    def _exec_aggregate(self, plan: pp.PHashAggregate) -> ColumnBatch:
        if plan.mode != "single":
            raise NotImplementedError(
                f"query_engine_tpu_torch does not execute {plan.mode} "
                "aggregates yet"
            )
        for agg in plan.agg_exprs:
            if agg.func not in _AGG_FUNCS or agg.distinct:
                raise NotImplementedError(
                    f"query_engine_tpu_torch does not evaluate {agg.name()} yet"
                )
        batch = self.execute(plan.input)
        cap = batch.capacity
        schema = plan.schema()
        dev = self.device

        kernel_bound = None  # dense-gid bound when direct grouping applied
        if plan.group_exprs:
            gvals = [self.evaluator.eval(g, batch) for g in plan.group_exprs]
            gid, ng, rep, kernel_bound = self._group_ids_best(
                gvals, batch.num_rows
            )
            num_groups = self._host_int(ng)
        else:
            gvals = []
            gid = torch.zeros(cap, dtype=torch.int64, device=dev)
            num_groups = 1  # global aggregate: one row even on empty input

        out_cap = padded_capacity(num_groups)
        cols: List[Column] = []
        # group key columns at representative rows
        for v, f in zip(gvals, schema):
            cols.append(Column(v.data[rep][:out_cap],
                               v.validity[rep][:out_cap], f.data_type,
                               v.dictionary))

        lm = K.live_mask(cap, batch.num_rows, dev)
        args = [
            None if agg.expr is None else self.evaluator.eval(agg.expr, batch)
            for agg in plan.agg_exprs
        ]
        # SUM/COUNT/AVG over dense bounded groups: one group_agg call for
        # all of them (the kernel on CUDA, its plain version on the CPU)
        use_kernel = self._mxu_agg_enabled(kernel_bound)
        items, item_of = [], {}
        slots = []  # per aggregate: its item in `items`, or None
        for agg, av in zip(plan.agg_exprs, args):
            eligible = use_kernel and agg.func in _KERNEL_FUNCS and (
                av is None or (av.dictionary is None
                               and av.data.dtype != torch.bool)
            )
            if not eligible:
                slots.append(None)
                continue
            key = "__star" if av is None else _expr_struct_key(agg.expr)
            if key not in item_of:
                item_of[key] = len(items)
                if av is None:
                    items.append((torch.ones(cap, dtype=torch.int64,
                                             device=dev), lm))
                else:
                    vals = av.data if av.data.is_floating_point() \
                        else av.data.to(torch.int64)
                    items.append((vals, lm & av.validity))
            slots.append(item_of[key])
        results = []
        if items:
            # static bound padded to cover out_cap (<= padded(nb + 1))
            results = group_agg.grouped_sums_counts_multi(
                items, gid.to(torch.int32), padded_capacity(kernel_bound)
            )

        for fi, (agg, av, slot) in enumerate(
            zip(plan.agg_exprs, args, slots), start=len(gvals)
        ):
            f = schema.field(fi)
            func = agg.func
            if slot is not None:
                sums, counts = results[slot]
                sums, counts = sums[:out_cap], counts[:out_cap]
                if func is lp.AggFunc.COUNT:
                    out_d = counts
                    out_v = torch.ones(out_cap, dtype=torch.bool, device=dev)
                elif func is lp.AggFunc.SUM:
                    out_d, out_v = sums, counts > 0
                else:  # AVG
                    out_d = sums.to(torch.float64) / counts.clamp(min=1)
                    out_v = counts > 0
                cols.append(Column(out_d, out_v, f.data_type, None))
                continue
            fname = "count_star" if av is None else func.value.lower()
            data = None if av is None else av.data
            validity = None if av is None else av.validity
            if not plan.group_exprs:
                vals, valid = K.global_aggregate(
                    fname,
                    data if data is not None else torch.zeros(
                        cap, dtype=torch.int64, device=dev),
                    validity if validity is not None else torch.ones(
                        cap, dtype=torch.bool, device=dev),
                    batch.num_rows, out_cap,
                )
            else:
                vals, valid = K.segment_aggregate(
                    fname, data, validity, gid, batch.num_rows, cap,
                )
            out_d = vals[:out_cap]
            out_v = valid[:out_cap]
            out_dict = (
                av.dictionary
                if func in (lp.AggFunc.MIN, lp.AggFunc.MAX) and av is not None
                else None
            )
            if out_dict is not None:
                out_d = out_d.to(torch.int32)
            cols.append(Column(out_d, out_v, f.data_type, out_dict))

        return ColumnBatch(schema, cols, num_groups)

    def _group_ids_best(self, gvals, num_rows):
        """Returns (gid, ng, rep, static_bound). static_bound is the dense
        gid upper bound when direct grouping applied (None otherwise)."""
        if len(gvals) == 1:
            v = gvals[0]
            if v.dictionary is not None:
                nb = max(len(v.dictionary), 1)
                if nb <= self._DIRECT_GROUP_MAX_RANGE:
                    g, ng, rep = K.group_ids_direct(
                        v.data, v.validity, num_rows, 0, nb
                    )
                    return g, ng, rep, nb + 1
            elif not v.data.is_floating_point():
                data = v.data.to(torch.int32) if v.data.dtype == torch.bool \
                    else v.data
                kmin, kmax, anyv = K.key_range(data, v.validity, num_rows)
                self.host_syncs += 1  # one read of the three scalars
                lo, hi, anyv = torch.stack(
                    [kmin.to(torch.int64), kmax.to(torch.int64),
                     anyv.to(torch.int64)]
                ).tolist()
                if anyv and hi - lo + 1 <= self._DIRECT_GROUP_MAX_RANGE:
                    g, ng, rep = K.group_ids_direct(
                        data, v.validity, num_rows, lo, hi - lo + 1
                    )
                    return g, ng, rep, hi - lo + 2
        g, ng, rep = K.group_ids(
            [v.data for v in gvals], [v.validity for v in gvals], num_rows
        )
        return g, ng, rep, None

    def _mxu_agg_enabled(self, bound) -> bool:
        """The group_agg route (the JAX name kept): a static dense-gid bound
        of at most _MXU_AGG_MAX_GROUPS. Any device: the wrapper runs the
        kernel on CUDA and its plain version on the CPU."""
        return bound is not None and bound <= self._MXU_AGG_MAX_GROUPS

    # ---- sort / limit --------------------------------------------------
    def _sort_val_keys(
        self, keys: Sequence[lp.SortKey], batch: ColumnBatch
    ):
        datas, valids, ascs, nfs = [], [], [], []
        for k in keys:
            v = self.evaluator.eval(k.expr, batch)
            datas.append(v.data)
            valids.append(v.validity)
            ascs.append(k.asc)
            nfs.append(k.resolved_nulls_first())
        return datas, valids, ascs, nfs

    def _exec_sort(self, plan: pp.PSort) -> ColumnBatch:
        batch = self.execute(plan.input)
        datas, valids, ascs, nfs = self._sort_val_keys(plan.keys, batch)
        perm = K.sort_permutation(datas, valids, ascs, nfs, batch.num_rows)
        return _take(batch, perm, batch.num_rows)

    def _exec_limit(self, plan: pp.PLimit) -> ColumnBatch:
        # top-k fusion: LIMIT over a Sort gathers only the fetched window of
        # the permutation instead of materializing the full sorted batch
        if isinstance(plan.input, pp.PSort) and plan.fetch is not None:
            sort_plan = plan.input
            batch = self.execute(sort_plan.input)
            datas, valids, ascs, nfs = self._sort_val_keys(sort_plan.keys, batch)
            perm = K.sort_permutation(datas, valids, ascs, nfs, batch.num_rows)
            lo = min(plan.skip, batch.num_rows)
            k = min(plan.skip + plan.fetch, batch.num_rows) - lo
            cap = padded_capacity(k)
            idx = torch.zeros(cap, dtype=torch.int64, device=perm.device)
            idx[:k] = perm[lo:lo + k]
            return _take(batch, idx, k,
                         row_valid=K.live_mask(cap, k, perm.device))
        batch = self.execute(plan.input)
        fetch = plan.fetch if plan.fetch is not None else batch.num_rows
        return batch.slice(plan.skip, fetch)


_EQUI_JOINS = {lp.JoinType.INNER, lp.JoinType.LEFT, lp.JoinType.RIGHT,
               lp.JoinType.FULL}
_LEFT_OUTER = {lp.JoinType.LEFT, lp.JoinType.FULL}
_RIGHT_OUTER = {lp.JoinType.RIGHT, lp.JoinType.FULL}
_AGG_FUNCS = {lp.AggFunc.COUNT, lp.AggFunc.SUM, lp.AggFunc.AVG,
              lp.AggFunc.MIN, lp.AggFunc.MAX}
_KERNEL_FUNCS = {lp.AggFunc.SUM, lp.AggFunc.COUNT, lp.AggFunc.AVG}
