"""Physical plan executor.

The counterpart of `query_engine_tpu.engine.executor.QueryExecutor`, for
these nodes: scan, projection, filter, INNER, LEFT, RIGHT and FULL
equi-joins (with or without a residual ON condition), CROSS joins, grouped
and global aggregate (DISTINCT included), sort, limit, window functions,
DISTINCT, UNION [ALL] / INTERSECT / EXCEPT, VALUES, the empty relation,
generate_series, UNNEST, derived tables (a subquery in FROM) and shared
WITH queries, materialized once per query, and index scans (the row ids
come from the host index, the gather runs on the device). Any other node
raises ExecutionError, as in the JAX package. Subquery expressions run
their plans through `execute` (the evaluator's `subquery_exec`).

The aggregates are COUNT/SUM/AVG/MIN/MAX, the ordered-set aggregates
(PERCENTILE_CONT/DISC, MEDIAN, MODE: one sort of the argument by group and
value on the device, shared by the quantiles over one plane), and
STRING_AGG and ARRAY_AGG, finalized on the host as in the reference. An
ARRAY_AGG result is a LIST column: a dictionary of Python lists, one per
group, in group order (not sorted), which UNNEST and the LIST functions
read.

An aggregate runs in one of three modes: `single`, or the distributed
stage walk's `partial` (AVG as a float64 sum and an int64 count plane) and
`final` (a combine of the partial planes after the group keys); every
grouped COUNT, SUM and AVG on a CUDA tensor goes to group_agg in each.

As in the JAX package, every node first goes to the compiled pipeline
(engine/pipeline.py, on unless QE_COMPILED=0), which runs the largest
segment it supports as one static program; what it declines runs in the
eager walk below, which is also the pipeline's semantics oracle. Before
the pipeline, an aggregate over a table of QE_CHUNK_ENGAGE rows or more
runs chunked (engine/chunked.py): a partial program per row chunk, then a
final combine.

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

import numpy as np
import torch

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, padded_capacity, to_tensor,
)
from query_engine_tpu_torch.columnar.dictionary import Dictionary
from query_engine_tpu_torch.engine.chunked import ChunkedAggregate
from query_engine_tpu_torch.engine.expr_eval import Evaluator, Val, unify_dicts
from query_engine_tpu_torch.engine import window as W
from query_engine_tpu_torch.engine.pipeline import (
    CompiledPipeline, compiled_enabled,
)
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp
from query_engine_tpu_torch.utils.profiling import span


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

    def __init__(self, device, udfs=None):
        self.device = torch.device(device)
        self.udfs = udfs
        self.evaluator = Evaluator(self.device, udfs=udfs,
                                   subquery_exec=self.execute)
        self.host_syncs = 0  # scalar/plane reads from the device, cumulative
        self.index_scans = 0  # IndexScan nodes run, cumulative
        # host ms of the host-finalized operators (STRING_AGG, ARRAY_AGG,
        # UNNEST), cumulative by kind
        self.host_ms = {}
        # per query: the batch of each shared (multiply referenced) WITH
        # query, keyed by id() of its shared physical node; every reference
        # reads this one batch. The Session clears it around a query.
        self._cte_memo = {}
        self.pipeline = CompiledPipeline(self)
        self.evaluator.like_phase = self.pipeline.like_phase
        self._compiled = compiled_enabled()
        self.chunked = ChunkedAggregate(self)

    # A counted read waits for the device: its host ms go to the
    # pipeline's `sync_ms` beside the other phases' ms (inside an eager
    # leaf, to the leaf's `leaf_ms`).
    def _host_int(self, t: torch.Tensor) -> int:
        self.host_syncs += 1
        with self.pipeline.phase("sync", "sync_ms"):
            return int(t.item())

    def _host_list(self, t: torch.Tensor):
        """One counted read of a whole tensor (t.tolist())."""
        self.host_syncs += 1
        with self.pipeline.phase("sync", "sync_ms"):
            return t.tolist()

    def _host_np(self, t: torch.Tensor) -> np.ndarray:
        """One counted read of a whole plane, as a numpy array."""
        self.host_syncs += 1
        with self.pipeline.phase("sync", "sync_ms"):
            return t.cpu().numpy()

    def _host_pylist(self, v: Val, n: int) -> list:
        """The first n rows of a value as Python values (None for NULL):
        one counted read each of its data and validity planes."""
        host = Column(torch.from_numpy(self._host_np(v.data)),
                      torch.from_numpy(self._host_np(v.validity)), v.dtype,
                      v.dictionary)
        return host.to_pylist(n)

    # ---- entry ---------------------------------------------------------
    def execute(self, plan: pp.PhysicalPlan) -> ColumnBatch:
        from query_engine_tpu_torch.utils.profiling import GLOBAL_PROFILER

        if not GLOBAL_PROFILER.enabled:
            return self._execute_node(plan)
        name = type(plan).__name__
        name = (name[1:] if name.startswith("P") else name).lower() or "node"
        if self._compiled:
            out = self.chunked.try_execute(plan)  # engages above threshold
            if out is not None:
                return out
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
        if isinstance(plan, _Materialized):
            return plan.batch
        if self._compiled and not _skip_compiled:
            # 100M+-row aggregates run chunked (partial per row-chunk ->
            # final combine) to bound device memory; engages only from the
            # QE_CHUNK_ENGAGE capacity on
            out = self.chunked.try_execute(plan)
            if out is not None:
                return out
            out = self.pipeline.try_execute(plan)
            if out is not None:
                return out
        if isinstance(plan, pp.PScan):
            return self._exec_scan(plan)
        if isinstance(plan, pp.PIndexScan):
            return self._exec_index_scan(plan)
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
        if isinstance(plan, pp.PSubquery):
            # a derived table or a WITH query: its child's batch under the
            # subquery's names. A shared one (referenced more than once)
            # runs once per query and every reference reads the SAME batch,
            # so float aggregates over it are bit-identical everywhere (Q15
            # compares its MAX with its rows)
            if plan.shared:
                child = self._cte_memo.get(id(plan.input))
                if child is None:
                    child = self.execute(plan.input)
                    self._cte_memo[id(plan.input)] = child
            else:
                child = self.execute(plan.input)
            return ColumnBatch(plan.out_schema, child.columns, child.num_rows)
        if isinstance(plan, pp.PWindow):
            return self._exec_window(plan)
        if isinstance(plan, pp.PDistinct):
            return self._exec_distinct(plan)
        if isinstance(plan, pp.PSetOp):
            return self._exec_setop(plan)
        if isinstance(plan, pp.PEmpty):
            return self._exec_empty(plan)
        if isinstance(plan, pp.PValues):
            return self._exec_values(plan)
        if isinstance(plan, pp.PGenerateSeries):
            return self._exec_generate_series(plan)
        if isinstance(plan, pp.PUnnest):
            return self._exec_unnest(plan)
        raise ExecutionError(f"cannot execute {type(plan).__name__}")

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

    def _exec_index_scan(self, plan: pp.PIndexScan) -> ColumnBatch:
        """The index lookup on the host (`plan.lookup()`), its row ids to
        the device once, the gather there, then the residual filter."""
        batch = plan.source.scan()
        if plan.projection is not None:
            batch = batch.select(plan.projection)
        ensure_device(batch, self.device)
        row_ids = np.asarray(plan.lookup(), dtype=np.int64)
        self.index_scans += 1
        out = batch.take(torch.from_numpy(row_ids).to(self.device),
                         len(row_ids))
        out = ColumnBatch(plan.out_schema, out.columns, out.num_rows)
        if plan.residual is not None:
            out = self._filter_batch(out, plan.residual)
        return out

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
        if jt in _OUTER and not plan.key_pairs \
                and plan.residual is not None:
            raise NotImplementedError(
                f"query_engine_tpu_torch does not execute a {jt.value} join "
                "without equi-keys yet"
            )
        if jt is lp.JoinType.CROSS or not plan.key_pairs:
            if jt is not lp.JoinType.CROSS:
                raise ExecutionError("non-cross join requires equi-keys")
            return self._cross_join(plan)
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

    def _cross_join(self, plan: pp.PHashJoin) -> ColumnBatch:
        """Every (left, right) pair, left-major."""
        self.pipeline.stats["cross_joins"] += 1
        left = self.execute(plan.left)
        right = self.execute(plan.right)
        total = left.num_rows * right.num_rows
        li, ri, valid = K.cross_join_indices(
            left.num_rows, right.num_rows, padded_capacity(total), self.device)
        return self._assemble_join(plan, left, right, li, ri, valid, valid,
                                   total)

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
        for agg in plan.agg_exprs:
            if agg.func not in _AGG_FUNCS:
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

        if plan.mode == "final":
            cols += self._final_aggregates(plan, batch, gid, len(gvals),
                                           out_cap)
            return ColumnBatch(schema, cols, num_groups)

        lm = K.live_mask(cap, batch.num_rows, dev)
        args = [
            None if agg.expr is None
            else self.evaluator.eval_agg_arg(agg, batch)
            for agg in plan.agg_exprs
        ]
        # SUM/COUNT/AVG over dense bounded groups: one group_agg call for
        # all of them (the kernel on CUDA, its plain version on the CPU)
        use_kernel = self._mxu_agg_enabled(kernel_bound)
        items, item_of = [], {}
        slots = []  # per aggregate: its item in `items`, or None
        for agg, av in zip(plan.agg_exprs, args):
            # a DISTINCT aggregate takes the segment route with its dedup
            # plane (the JAX package keeps it off this one too)
            eligible = use_kernel and agg.func in _KERNEL_FUNCS \
                and not agg.distinct and (
                    av is None or (av.dictionary is None
                                   and av.data.dtype != torch.bool))
            if not eligible:
                slots.append(None)
                continue
            # AVG over a DECIMAL sums descaled values: not SUM's item
            key = "__star" if av is None else (_expr_struct_key(agg.expr),
                                               str(av.dtype))
            if key not in item_of:
                item_of[key] = len(items)
                if av is None:
                    items.append((None, lm))  # COUNT(*) reads only lm
                else:
                    vals = av.data if av.data.is_floating_point() \
                        else av.data.to(torch.int64)
                    items.append((vals, lm & av.validity))
            slots.append(item_of[key])
        results = []
        if items:
            # static bound padded to cover out_cap (<= padded(nb + 1))
            results = group_agg.grouped_sums_counts_multi(
                items, gid, padded_capacity(kernel_bound)
            )

        pct_sort_cache = {}
        fi = len(gvals)
        for agg, av, slot in zip(plan.agg_exprs, args, slots):
            f = schema.field(fi)
            fi += 1
            func = agg.func
            if plan.mode == "partial" and func is lp.AggFunc.AVG:
                # AVG's partial pair: a float64 sum plane and an int64
                # count plane (the partial schema, plan/physical.py)
                fi += 1
                cols += self._partial_avg(av, slot, results, gid, batch,
                                          plan.group_exprs, out_cap)
                continue
            if func in lp.ORDERED_SET_FNS:
                out_d, out_v = self._grouped_percentile(
                    agg, av.data, av.validity, gid, batch.num_rows, cap,
                    out_cap, pct_sort_cache)
                cols.append(Column(out_d[:out_cap], out_v[:out_cap],
                                   f.data_type, None))
                continue
            if func is lp.AggFunc.STRING_AGG:
                cols.append(self._grouped_string_agg(agg, av, gid, batch,
                                                     cap, out_cap))
                continue
            if func is lp.AggFunc.ARRAY_AGG:
                cols.append(self._grouped_array_agg(agg, av, gid, batch, cap,
                                                    out_cap, f.data_type))
                continue
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
            distinct_first = None
            if agg.distinct and av is not None:
                distinct_first = K.distinct_first_flags(
                    [data], [validity], gid, batch.num_rows)
            if plan.group_exprs or distinct_first is not None:
                # a global DISTINCT aggregate too: its dedup plane takes the
                # segment route, every row in segment 0
                vals, valid = K.segment_aggregate(
                    fname, data, validity, gid, batch.num_rows,
                    cap if plan.group_exprs else out_cap,
                    distinct_first=distinct_first,
                )
            else:
                vals, valid = K.global_aggregate(
                    fname,
                    data if data is not None else torch.zeros(
                        cap, dtype=torch.int64, device=dev),
                    validity if validity is not None else torch.ones(
                        cap, dtype=torch.bool, device=dev),
                    batch.num_rows, out_cap,
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

    def _partial_avg(self, av, slot, results, gid, batch, grouped, out_cap):
        """The (sum, count) columns of a partial AVG: from its group_agg
        item when it has one, else from one group_agg call of its own over
        the segment ids."""
        dev = self.device
        if slot is not None:
            sums, counts = results[slot]
        else:
            nseg = batch.capacity if grouped else out_cap
            ok = K.live_mask(batch.capacity, batch.num_rows, dev) \
                & av.validity
            sums, counts = group_agg.grouped_sums_counts_multi(
                [(av.data.to(torch.float64), ok)], gid, nseg)[0]
        counts = counts[:out_cap]
        s, has = sums[:out_cap].to(torch.float64), counts > 0
        ones = torch.ones(out_cap, dtype=torch.bool, device=dev)
        return [Column(s, has, DataType.float64(), None),
                Column(counts, ones, DataType.int64(), None)]

    def _final_aggregates(self, plan, batch, gid, ci, out_cap):
        """The combine of a final aggregate: the input's columns after the
        group keys are the partial planes in aggregate order (an AVG's sum
        and count pair included). COUNT and SUM partials add, MIN and MAX
        take their extreme, AVG divides its summed pair. Every COUNT, SUM
        and AVG plane is one item of a single group_agg call; MIN and MAX
        take the segment route (`K.segment_aggregate`)."""
        schema = plan.schema()
        nseg = batch.capacity if plan.group_exprs else out_cap
        n = batch.num_rows
        lm = K.live_mask(batch.capacity, n, self.device)
        items, planes = [], []  # planes: per aggregate, its items or column
        for agg in plan.agg_exprs:
            if agg.func not in _COMBINE and agg.func is not lp.AggFunc.AVG:
                raise ExecutionError(f"{agg.name()} has no final combine")
            width = 2 if agg.func is lp.AggFunc.AVG else 1
            cols = batch.columns[ci: ci + width]
            ci += width
            if agg.func in (lp.AggFunc.MIN, lp.AggFunc.MAX):
                planes.append(cols[0])
                continue
            planes.append(list(range(len(items), len(items) + width)))
            items += [(c.data, lm & c.validity) for c in cols]
        results = (group_agg.grouped_sums_counts_multi(items, gid, nseg)
                   if items else [])
        out = []
        for fi, (agg, src) in enumerate(zip(plan.agg_exprs, planes),
                                        start=len(plan.group_exprs)):
            f = schema.field(fi)
            if isinstance(src, Column):
                vals, valid = K.segment_aggregate(
                    _COMBINE[agg.func], src.data, src.validity, gid, n, nseg)
                out_d = vals[:out_cap]
                if src.dictionary is not None:
                    out_d = out_d.to(torch.int32)
                out.append(Column(out_d, valid[:out_cap], f.data_type,
                                  src.dictionary))
                continue
            s, cnt = results[src[0]]
            s, has = s[:out_cap], cnt[:out_cap] > 0
            if agg.func is lp.AggFunc.AVG:
                c = results[src[1]][0][:out_cap]
                out_d = s.to(torch.float64) / c.clamp(min=1).to(torch.float64)
                out.append(Column(out_d, has & (c > 0), f.data_type, None))
            elif agg.func is lp.AggFunc.COUNT:
                out.append(Column(s, torch.ones_like(has), f.data_type, None))
            else:  # SUM
                out.append(Column(s, has, f.data_type, None))
        return out

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
                lo, hi, anyv = self._host_list(torch.stack(
                    [kmin.to(torch.int64), kmax.to(torch.int64),
                     anyv.to(torch.int64)]))  # one read of the three scalars
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

    # ---- ordered-set aggregates ------------------------------------------
    def _grouped_percentile(self, agg, data, validity, gid, num_rows, cap,
                            out_cap, sort_cache):
        """Sort-based per-group quantile (PERCENTILE_CONT/DISC, MEDIAN) and
        MODE: one sort of the live valid rows by (group, value) in float
        total order (`K.sort_by_group_value`), then each group's target
        position from its start and count, and one gather (two and a lerp
        for CONT). O(n log n) in rows and O(G) after it: no per-group loop.

        PG semantics: CONT interpolates at frac*(c-1); DISC returns the
        first value whose cume_dist >= frac (1-based index ceil(frac*c)).
        DESC mirrors the index from the other end. MODE: the most frequent
        value per group, ties to the FIRST value in the WITHIN GROUP order
        (`K.group_mode_sorted`). Empty groups are NULL."""
        frac, desc = agg.param
        fn = agg.func
        # quantiles over one plane (P50/P90/MEDIAN dashboards) share ONE
        # sort per (argument plane, value representation). The entry keeps
        # the keying tensors ALIVE: id() of a freed tensor can be reused
        ck = (id(data), id(validity), fn is lp.AggFunc.PERCENTILE_CONT)
        if ck not in sort_cache:
            ok = K.live_mask(cap, num_rows, self.device) & validity
            vals = (data.to(torch.float64)
                    if fn is lp.AggFunc.PERCENTILE_CONT else data)
            sort_cache[ck] = (data, validity,
                              K.sort_by_group_value(vals, ok, gid, out_cap))
        skey, sval, c, start = sort_cache[ck][2]
        if fn is lp.AggFunc.MODE:
            return K.group_mode_sorted(skey, sval, out_cap, desc), c > 0
        if fn is lp.AggFunc.PERCENTILE_CONT:
            fr = 1.0 - frac if desc else frac
            pos = fr * (c - 1).clamp(min=0).to(torch.float64)
            lo = torch.floor(pos).to(torch.int64)
            hi = torch.ceil(pos).to(torch.int64)
            w = pos - lo.to(torch.float64)
            vlo = sval[(start + lo).clamp(0, cap - 1)]
            vhi = sval[(start + hi).clamp(0, cap - 1)]
            out = vlo * (1.0 - w) + vhi * w
        else:
            k_ = torch.ceil(frac * c.to(torch.float64)).to(torch.int64)
            k_ = torch.minimum(k_.clamp(min=1), c.clamp(min=1))
            idx = (c - k_) if desc else (k_ - 1)
            out = sval[(start + idx).clamp(0, cap - 1)]
        return out, c > 0

    # ---- host-finalized aggregates (STRING_AGG, ARRAY_AGG) ----------------
    def _agg_host_row_order(self, agg, batch, rows: np.ndarray) -> np.ndarray:
        """Order the host row indices of one order-sensitive aggregate by
        its in-call ORDER BY (ARRAY_AGG(x ORDER BY k)): a stable sort from
        the last key to the first, NULLs placed by the resolved NULLS
        FIRST/LAST. Input order is kept when there is no ORDER BY (PG leaves
        it unspecified; input order is deterministic here).

        The reference sorts Python values; a key whose plane orders as its
        values do (integers, dates, booleans, NaN-free floats, the codes of
        a sorted string dictionary) sorts its plane with numpy's stable
        sort, the same order; any other key sorts its Python values."""
        if not agg.order_by:
            return rows
        for k, asc, nulls_first in reversed(agg.order_by):
            kv = self.evaluator.eval(k, batch)
            valid = self._host_np(kv.validity)[rows]
            nn, nulls = rows[valid], rows[~valid]
            plane = self._orderable_plane(kv, nn)
            if plane is not None:
                if asc:
                    nn = nn[np.argsort(plane, kind="stable")]
                else:
                    # Python's reverse=True keeps equal keys in input order
                    nn = nn[::-1][np.argsort(plane[::-1], kind="stable")][::-1]
            else:
                vals = self._host_pylist(kv, kv.data.shape[0])
                nn = np.asarray(sorted(nn.tolist(), key=lambda i: vals[i],
                                       reverse=not asc), dtype=np.int64)
            rows = np.concatenate([nulls, nn] if nulls_first else [nn, nulls])
        return rows

    def _orderable_plane(self, kv: Val, rows: np.ndarray):
        """The key plane at `rows` when it sorts as the key's Python values
        do, else None."""
        kind = kv.dtype.kind
        if kv.dictionary is not None:
            if kind is TypeKind.LIST:  # a LIST dictionary is not sorted
                return None
            return self._host_np(kv.data)[rows]
        if kind not in _PLANE_ORDERED:
            return None
        plane = self._host_np(kv.data)[rows]
        if plane.dtype.kind == "f" and np.isnan(plane).any():
            return None
        return plane

    @staticmethod
    def _dedup_keep_order(vals):
        seen = set()
        out = []
        for v in vals:
            k = (v is None, v)
            if k not in seen:
                seen.add(k)
                out.append(v)
        return out

    def _host_groups(self, gid, rows: np.ndarray, out_cap: int):
        """{group: its rows, in `rows` order} for the groups in
        [0, out_cap): one read of the gid plane and a stable sort."""
        g = self._host_np(gid)[rows]
        keep = (g >= 0) & (g < out_cap)
        g, rows = g[keep], rows[keep]
        order = np.argsort(g, kind="stable")
        g, rows = g[order], rows[order]
        cut = np.flatnonzero(np.diff(g)) + 1
        return {int(gs[0]): rs for gs, rs in zip(np.split(g, cut),
                                                 np.split(rows, cut))
                if len(gs)}

    def _grouped_string_agg(self, agg, av, gid, batch, cap, out_cap):
        """STRING_AGG([DISTINCT] expr, delim [ORDER BY k]): host
        finalization, as in the reference, over one read each of the gid,
        code and validity planes. A string's code stands for it (the
        dictionary is sorted and unique), so DISTINCT keeps each group's
        first row of each code."""
        with span("string_agg", self.host_ms, "string_agg"):
            delim = agg.param[0]
            lm = K.live_mask(cap, batch.num_rows, self.device)
            ok = self._host_np(lm & av.validity)
            codes = self._host_np(av.data)
            values = av.dictionary.values if av.dictionary is not None else []
            rows = self._agg_host_row_order(agg, batch, np.flatnonzero(ok))
            out_strs = [None] * out_cap
            for gi, rs in self._host_groups(gid, rows, out_cap).items():
                cs = codes[rs]
                if agg.distinct:
                    _, first = np.unique(cs, return_index=True)
                    cs = cs[np.sort(first)]
                out_strs[gi] = delim.join(values[c] for c in cs.tolist())
            new_dict, new_codes = Dictionary.from_values(
                ["" if v is None else v for v in out_strs])
            valid = np.array([v is not None for v in out_strs], dtype=bool)
            out = Column(to_tensor(new_codes.astype(np.int32), self.device),
                         to_tensor(valid, self.device), DataType.utf8(),
                         new_dict)
        return out

    def _grouped_array_agg(self, agg, av, gid, batch, cap, out_cap, dtype):
        """ARRAY_AGG([DISTINCT] expr [ORDER BY k]) [FILTER (WHERE p)]:
        per-group Python lists; PG keeps NULL inputs (the result is NULL
        only for a group with no row, or every row filtered). FILTER
        excludes rows (the CASE desugar of the other aggregates would keep
        them as NULL elements). The result is a dictionary of Python lists
        with codes arange(out_cap): terminal output, as in the
        reference."""
        with span("array_agg", self.host_ms, "array_agg"):
            pyvals = self._host_pylist(av, cap)
            lm = K.live_mask(cap, batch.num_rows, self.device)
            if agg.filter is not None:
                fv = self.evaluator.eval(agg.filter, batch)
                lm = lm & fv.data.to(torch.bool) & fv.validity
            rows = self._agg_host_row_order(agg, batch,
                                            np.flatnonzero(self._host_np(lm)))
            values = np.empty(out_cap, dtype=object)
            valid = np.zeros(out_cap, dtype=bool)
            for gi, rs in self._host_groups(gid, rows, out_cap).items():
                vs = [pyvals[i] for i in rs.tolist()]
                values[gi] = self._dedup_keep_order(vs) if agg.distinct else vs
                valid[gi] = True
            out = Column(torch.arange(out_cap, dtype=torch.int32,
                                      device=self.device),
                         to_tensor(valid, self.device), dtype,
                         Dictionary(values))
        return out

    # ---- UNNEST ---------------------------------------------------------
    def _exec_unnest(self, plan: pp.PUnnest) -> ColumnBatch:
        """Lateral list explosion: input rows in order, each list's
        elements in order; a NULL or empty list gives no row. A LIST value
        is a dictionary of Python lists, so each dictionary VALUE's length
        and elements are read once on the host (`_unnest_table`); the rows
        take their lengths by one gather on the device, each output row
        finds its base row by a searchsorted of the running total, and its
        element is one gather from the flattened elements. One host read:
        the total."""
        batch = self.execute(plan.input)
        v = self.evaluator.eval(plan.list_expr, batch)
        if v.dictionary is None:
            raise ExecutionError("UNNEST requires a LIST value")
        if v.data.dim() != 1:
            # the reference reads each row's code with int(), which fails
            # the same way on the 2-D code plane of a LIST dictionary whose
            # lists all have one length (Dictionary.map_values)
            raise TypeError(
                "only length-1 arrays can be converted to Python scalars")
        with span("unnest", self.host_ms, "unnest"):
            fld = plan.out_schema.field(len(plan.out_schema) - 1)
            lengths, offsets, elems = self._unnest_table(v.dictionary,
                                                         fld.data_type)
            dev, cap, n = self.device, batch.capacity, batch.num_rows
            nd = len(lengths)
            code = v.data.to(torch.int64)
            ok = (K.live_mask(cap, n, dev) & v.validity & (code >= 0)
                  & (code < nd))
            code = code.clamp(0, max(nd - 1, 0))
            len_t = to_tensor(lengths if nd else np.zeros(1, np.int64), dev)
            off_t = to_tensor(offsets if nd else np.zeros(1, np.int64), dev)
            per_row = torch.where(ok, len_t[code], 0)
            total = self._host_int(per_row.sum())
            out_cap = padded_capacity(total)
            # output row j belongs to the input row whose run of the running
            # total holds j: repeat_interleave(arange(cap), per_row)
            ends = torch.cumsum(per_row, 0)
            j = torch.arange(total, device=dev)
            ridx = torch.searchsorted(ends, j, right=True)
            eidx = off_t[code[ridx]] + j - (ends - per_row)[ridx]
            live = K.live_mask(out_cap, total, dev)
            pad = torch.zeros(out_cap - total, dtype=torch.int64, device=dev)
            ridx, eidx = torch.cat([ridx, pad]), torch.cat([eidx, pad])
            cols = list(_take(batch, ridx, total, row_valid=live).columns) \
                if batch.columns else []
            cols.append(Column(elems.data[eidx], elems.validity[eidx] & live,
                               fld.data_type, elems.dictionary))
        return ColumnBatch(plan.out_schema, cols, total)

    def _unnest_table(self, d: Dictionary, elem_type: DataType):
        """(lengths, offsets, elements column) of a LIST dictionary's
        values, in the reference's reading: None is an empty list, a list
        or tuple its elements, anything else a one-element list. Kept on
        the dictionary per element type and device, so a warm query finds
        the same element column (and dictionary) again."""
        key = ("unnest", elem_type.kind, elem_type.params, str(self.device))
        if d._maps is not None and key in d._maps:
            return d._maps[key]
        lists = []
        for x in d.values:
            if x is None:
                lists.append([])
            elif isinstance(x, (list, tuple)):
                lists.append(list(x))
            else:
                lists.append([x])
        lengths = np.asarray([len(x) for x in lists], dtype=np.int64)
        offsets = np.cumsum(lengths) - lengths
        flat = [e for x in lists for e in x]
        elems = ColumnBatch.from_pydict(
            {"v": flat}, Schema([Field("v", elem_type, True)]),
            device=self.device).columns[0]
        out = (lengths, offsets, elems)
        if d._maps is None:
            d._maps = {}
        d._maps[key] = out
        return out

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

    # ---- window --------------------------------------------------------
    def _exec_window(self, plan: pp.PWindow) -> ColumnBatch:
        """Each window function over its OVER spec's sort (one sort per
        distinct spec), its values scattered back to row order through the
        inverse permutation."""
        batch = self.execute(plan.input)
        cap, n = batch.capacity, batch.num_rows
        out_cols = list(batch.columns)
        schema = plan.schema()
        spec_cache = {}
        for wi, wexpr in enumerate(plan.window_exprs):
            spec_key = (
                tuple(_expr_struct_key(p) for p in wexpr.partition_by),
                tuple((_expr_struct_key(k.expr), k.asc,
                       k.resolved_nulls_first()) for k in wexpr.order_by),
            )
            if spec_key not in spec_cache:
                spec_cache[spec_key] = self._window_spec(wexpr, batch)
            perm, inv, pad_sorted, seg_change, peer_change, seg = \
                spec_cache[spec_key]

            def arg(e, perm=perm):
                v = self.evaluator.eval(e, batch)
                return v, v.data[perm], v.validity[perm]

            svals, svalid, out_dict = W.sorted_values(
                wexpr, seg_change, peer_change, seg, pad_sorted, arg)
            out_d = svals[inv]
            out_v = svalid[inv] & K.live_mask(cap, n, self.device)
            if out_dict is not None:
                out_d = out_d.to(torch.int32)
            f = schema.field(len(batch.columns) + wi)
            out_cols.append(Column(out_d, out_v, f.data_type, out_dict))
        return ColumnBatch(schema, out_cols, n)

    def _window_spec(self, wexpr, batch):
        """One OVER spec's sort: (perm, inverse perm, pad flags, segment
        flags, peer flags, segment ids), all in window order."""
        cap, dev = batch.capacity, self.device
        part_vals = [self.evaluator.eval(p, batch) for p in wexpr.partition_by]
        o_datas, o_valids, o_ascs, o_nfs = self._sort_val_keys(
            wexpr.order_by, batch)
        p_datas = [v.data for v in part_vals]
        p_valids = [v.validity for v in part_vals]
        if not (p_datas or o_datas):
            # OVER (): a constant key keeps the live rows in input order as
            # ONE partition
            p_datas = [torch.zeros(cap, dtype=torch.int32, device=dev)]
            p_valids = [torch.ones(cap, dtype=torch.bool, device=dev)]
        perm = K.sort_permutation(
            p_datas + o_datas, p_valids + o_valids,
            [True] * len(p_datas) + o_ascs, [False] * len(p_datas) + o_nfs,
            batch.num_rows)
        pad_sorted = torch.arange(cap, device=dev) >= batch.num_rows
        part_sorted, order_sorted = [], []
        for d, v in zip(p_datas, p_valids):
            key, null = K.normalize_key(d[perm], v[perm])
            part_sorted += [null.to(torch.int32), key]
        for d, v in zip(o_datas, o_valids):
            key, null = K.normalize_key(d[perm], v[perm])
            order_sorted += [null.to(torch.int32), key]
        seg_change, peer_change, seg = K.window_segments(
            part_sorted, order_sorted, pad_sorted)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(cap, device=dev)
        return perm, inv, pad_sorted, seg_change, peer_change, seg

    # ---- distinct / set ops --------------------------------------------
    def _exec_distinct(self, plan: pp.PDistinct) -> ColumnBatch:
        return self._distinct_batch(self.execute(plan.input), plan.on)

    def _distinct_batch(self, batch: ColumnBatch, on=None) -> ColumnBatch:
        """The first row of each distinct key (all columns, or the ON
        expressions), in input order; NULLs equal."""
        if on is not None:
            kvals = [self.evaluator.eval(e, batch) for e in on]
            kd = [v.data for v in kvals]
            kv = [v.validity for v in kvals]
        else:
            kd = [c.data for c in batch.columns]
            kv = [c.validity for c in batch.columns]
        cap, dev = kd[0].shape[0], kd[0].device
        gid = torch.zeros(cap, dtype=torch.int64, device=dev)
        first = K.distinct_first_flags(kd, kv, gid, batch.num_rows) \
            & K.live_mask(cap, batch.num_rows, dev)
        count = self._host_int(first.sum())
        idx = K.compaction_indices(first, batch.num_rows,
                                   padded_capacity(count))
        return _take(batch, idx, count)

    def _exec_setop(self, plan: pp.PSetOp) -> ColumnBatch:
        left = self.execute(plan.left)
        right = self.execute(plan.right)
        right = ColumnBatch(left.schema, right.columns, right.num_rows)
        if plan.kind in (lp.SetOpKind.UNION, lp.SetOpKind.UNION_ALL):
            # UNION's dedup is the Distinct node the planner adds above
            return ColumnBatch.concat([left, right])
        # INTERSECT / EXCEPT: set semantics with NULLs equal, left deduped
        lcols, rcols = [], []
        for lc, rc in zip(left.columns, right.columns):
            lval = Val(lc.data, lc.validity, lc.dtype, lc.dictionary)
            rval = Val(rc.data, rc.validity, rc.dtype, rc.dictionary)
            if lc.dictionary is not None or rc.dictionary is not None:
                lval, rval = unify_dicts(lval, rval)
            lcols.append((lval.data, lval.validity))
            rcols.append((rval.data, rval.validity))
        lr, rr = K.join_ranks(lcols, rcols, left.num_rows, right.num_rows,
                              null_equal=True)
        member = K.rank_member(lr, rr, K.live_mask(right.capacity,
                                                   right.num_rows, self.device))
        keep = member if plan.kind is lp.SetOpKind.INTERSECT else ~member
        count = self._host_int(K.filter_count(keep, left.num_rows))
        idx = K.compaction_indices(keep, left.num_rows, padded_capacity(count))
        return self._distinct_batch(_take(left, idx, count))

    # ---- leaf relations --------------------------------------------------
    def _exec_values(self, plan: pp.PValues) -> ColumnBatch:
        """VALUES rows: each expression evaluated over a one-row batch,
        then the columns encoded under the node's schema."""
        schema = plan.out_schema
        data = {f.name: [] for f in schema}
        one = ColumnBatch(Schema([]), [], 1)
        for row in plan.rows:
            for f, e in zip(schema, row):
                v = self.evaluator.eval(e, one)
                ok = bool(self._host_list(v.validity[:1])[0])
                if v.dictionary is not None:
                    code = self._host_list(v.data[:1])
                    val = v.dictionary.decode(np.asarray(code))[0]
                else:
                    val = self._host_list(v.data[:1])[0]
                data[f.name].append(val if ok else None)
        return ColumnBatch.from_pydict(data, schema, device=self.device)

    def _exec_empty(self, plan: pp.PEmpty) -> ColumnBatch:
        """No rows, or (SELECT without FROM) one row of NULLs."""
        if not plan.produce_one_row:
            return ColumnBatch.empty(plan.out_schema, device=self.device)
        cap = padded_capacity(1)
        cols = [
            Column(to_tensor(np.zeros(cap, f.data_type.device_dtype),
                             self.device),
                   torch.zeros(cap, dtype=torch.bool, device=self.device),
                   f.data_type,
                   Dictionary.empty() if f.data_type.is_dictionary else None)
            for f in plan.out_schema
        ]
        return ColumnBatch(plan.out_schema, cols, 1)

    def _exec_generate_series(self, plan: pp.PGenerateSeries) -> ColumnBatch:
        """An int64 (or temporal) arithmetic series: an iota on the device,
        or the planner's month-stepped values."""
        start, stop, step = plan.start, plan.stop, plan.step
        if plan.values is not None:  # month-stepped temporal series
            n = len(plan.values)
            host = np.zeros(padded_capacity(n), dtype=np.int64)
            host[:n] = plan.values
            data = to_tensor(host, self.device)
        else:
            if step > 0:
                n = 0 if start > stop else (stop - start) // step + 1
            else:
                n = 0 if start < stop else (start - stop) // (-step) + 1
            data = start + step * torch.arange(
                padded_capacity(n), dtype=torch.int64, device=self.device)
        col = Column(data, torch.ones(data.shape[0], dtype=torch.bool,
                                      device=self.device),
                     plan.out_schema.field(0).data_type, None)
        return ColumnBatch(plan.out_schema, [col], n)


_OUTER = {lp.JoinType.LEFT, lp.JoinType.RIGHT, lp.JoinType.FULL}
_LEFT_OUTER = {lp.JoinType.LEFT, lp.JoinType.FULL}
_RIGHT_OUTER = {lp.JoinType.RIGHT, lp.JoinType.FULL}
_AGG_FUNCS = {lp.AggFunc.COUNT, lp.AggFunc.SUM, lp.AggFunc.AVG,
              lp.AggFunc.MIN, lp.AggFunc.MAX, lp.AggFunc.STRING_AGG,
              lp.AggFunc.ARRAY_AGG} | lp.ORDERED_SET_FNS
_KERNEL_FUNCS = {lp.AggFunc.SUM, lp.AggFunc.COUNT, lp.AggFunc.AVG}
# a final aggregate's combine of each partial (AVG divides its pair)
_COMBINE = {lp.AggFunc.COUNT: "sum", lp.AggFunc.SUM: "sum",
            lp.AggFunc.MIN: "min", lp.AggFunc.MAX: "max"}
# the kinds whose plane (NaN aside) orders as their Python values: not
# UINT64 (an int64 plane), DECIMAL (read back as scaled floats), INTERVAL
_PLANE_ORDERED = {
    TypeKind.BOOLEAN, TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
    TypeKind.INT64, TypeKind.UINT8, TypeKind.UINT16, TypeKind.UINT32,
    TypeKind.FLOAT32, TypeKind.FLOAT64, TypeKind.DATE32, TypeKind.DATE64,
    TypeKind.TIMESTAMP,
}


class _Materialized(pp.PhysicalPlan):
    """Wraps an already-computed batch as a plan node (internal reuse)."""

    def __init__(self, batch: ColumnBatch):
        self.batch = batch

    def schema(self) -> Schema:
        return self.batch.schema
