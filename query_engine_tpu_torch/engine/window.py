"""Window functions over rows already in window order, shared by the eager
executor (engine/executor.py) and the compiled pipeline
(engine/pipeline.py): both sort the rows of an OVER spec, compute its
segment and peer flags (`K.window_segments`), and call `sorted_values` for
each function; they differ only in how an argument reaches window order
(the eager path gathers its planes through the permutation, a program
gathers them packed).

The counterpart of the window part of `query_engine_tpu.engine.executor`
(`classify_window_frame`, `_exec_window`, `_const_int`), with its errors:
FOLLOWING frame starts, PRECEDING frame ends, NTH_VALUE with n < 1, a
LAG/LEAD default over strings and MIN/MAX over a bounded RANGE offset
frame raise ExecutionError. AVG over a DECIMAL argument raises
NotImplementedError: the port has no decimal type yet.
"""

from __future__ import annotations

import torch

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.core.types import TypeKind
from query_engine_tpu_torch.engine.expr_eval import exact_div
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.plan import logical as lp

AGGREGATES = {lp.WindowFn.SUM, lp.WindowFn.COUNT, lp.WindowFn.AVG,
              lp.WindowFn.MIN, lp.WindowFn.MAX}
# functions whose value is a rank in 1..capacity (a packable gather)
RANKS = (lp.WindowFn.ROW_NUMBER, lp.WindowFn.RANK, lp.WindowFn.DENSE_RANK,
         lp.WindowFn.NTILE)
_VALUES = (lp.WindowFn.FIRST_VALUE, lp.WindowFn.LAST_VALUE,
           lp.WindowFn.NTH_VALUE)


def classify_window_frame(frame, has_order: bool):
    """Map an ast.WindowFrame (or None) onto the kernels' frame descriptor.
    PG defaults: no frame + ORDER BY => RANGE UNBOUNDED PRECEDING..CURRENT
    ROW (the current row and its peers); no ORDER BY => the whole
    partition."""
    if frame is None:
        return ("range_current",) if has_order else ("partition",)
    start, end = frame.start, frame.end
    mode = frame.mode.value if hasattr(frame.mode, "value") else str(frame.mode)
    if mode == "RANGE":
        if start.kind == "PRECEDING" and start.offset is None:
            if end is None or end.kind == "CURRENT":
                return ("range_current",)
            if end.kind == "FOLLOWING" and end.offset is None:
                return ("partition",)
            if end.kind == "FOLLOWING":
                return ("range_off", None, int(end.offset))
        # value-distance frames: RANGE BETWEEN x PRECEDING AND y FOLLOWING
        # over a single numeric ORDER BY key
        if start.kind == "CURRENT":
            s_off = 0
        elif start.kind == "PRECEDING":
            s_off = None if start.offset is None else int(start.offset)
        else:
            raise ExecutionError("FOLLOWING RANGE frame starts not supported")
        if end is None or end.kind == "CURRENT":
            e_off = 0
        elif end.kind == "FOLLOWING":
            e_off = None if end.offset is None else int(end.offset)
        else:
            raise ExecutionError("PRECEDING RANGE frame ends not supported")
        return ("range_off", s_off, e_off)
    # ROWS
    if start.kind == "CURRENT":
        s_off = 0
    elif start.kind == "PRECEDING":
        s_off = None if start.offset is None else int(start.offset)
    else:
        raise ExecutionError("FOLLOWING frame starts not supported")
    if end is None or end.kind == "CURRENT":
        e_off = 0
    elif end.kind == "FOLLOWING":
        e_off = None if end.offset is None else int(end.offset)
    else:
        raise ExecutionError("PRECEDING frame ends not supported")
    return ("rows", s_off, e_off)


def const_int(e: lp.LogicalExpr, default: int) -> int:
    """A window function's integer parameter (NTILE's n, LAG/LEAD's offset,
    NTH_VALUE's n): a literal read on the host, else `default`. A program
    keys these literals statically (pipeline._expr_key)."""
    if isinstance(e, lp.Literal) and e.value.value is not None:
        return int(e.value.value)
    return default


def static_args(w: lp.WindowExpr):
    """The arguments of `w` read on the host while a program is built."""
    if w.func is lp.WindowFn.NTILE:
        return w.args[:1]
    if w.func in (lp.WindowFn.LAG, lp.WindowFn.LEAD, lp.WindowFn.NTH_VALUE):
        return w.args[1:2]
    return []


def order_independent(w: lp.WindowExpr) -> bool:
    """Computed from segment and peer boundaries only, so the order that
    extra ORDER BY keys impose within a peer group does not show: the rank
    family without ROW_NUMBER/NTILE, and aggregates over the whole
    partition or RANGE .. CURRENT ROW (peers resolve them)."""
    fn = w.func
    if fn in (lp.WindowFn.RANK, lp.WindowFn.DENSE_RANK,
              lp.WindowFn.PERCENT_RANK, lp.WindowFn.CUME_DIST):
        return True
    if fn in AGGREGATES:
        try:
            kind = classify_window_frame(w.frame, bool(w.order_by))[0]
        except ExecutionError:
            return False
        return kind in ("partition", "range_current")
    return False


def sorted_values(w: lp.WindowExpr, seg_change, peer_change, seg, pad_sorted,
                  arg):
    """One window function in window order: (values, valid, dictionary).
    arg(e) -> (Val of e, its data and validity in window order)."""
    fn = w.func
    ones = torch.ones(seg_change.shape[0], dtype=torch.bool,
                      device=seg_change.device)
    if fn is lp.WindowFn.ROW_NUMBER:
        return K.row_number_sorted(seg_change), ones, None
    if fn is lp.WindowFn.RANK:
        return K.rank_sorted(seg_change, peer_change), ones, None
    if fn is lp.WindowFn.DENSE_RANK:
        return K.dense_rank_sorted(seg_change, peer_change), ones, None
    if fn is lp.WindowFn.NTILE:
        return (K.ntile_sorted(seg_change, const_int(w.args[0], 1),
                               pad_sorted), ones, None)
    if fn is lp.WindowFn.PERCENT_RANK:
        return K.percent_rank_sorted(seg_change, peer_change), ones, None
    if fn is lp.WindowFn.CUME_DIST:
        return K.cume_dist_sorted(seg_change, peer_change), ones, None

    def frame():
        fdesc = classify_window_frame(w.frame, bool(w.order_by))
        plane = range_off_plane(w, arg) if fdesc[0] == "range_off" else None
        return fdesc, plane

    if fn in _VALUES:
        av, sd, sv = arg(w.args[0])
        fdesc, plane = frame()
        lo, hi = K.window_frame_bounds(fdesc, seg_change, peer_change,
                                       pad_sorted, plane)
        if fn is lp.WindowFn.FIRST_VALUE:
            pos = lo
        elif fn is lp.WindowFn.LAST_VALUE:
            pos = hi
        else:
            nth = const_int(w.args[1], 1)
            if nth < 1:
                raise ExecutionError("NTH_VALUE position must be >= 1")
            pos = lo + (nth - 1)
        vals, valid = K.value_at(sd, sv, pos)
        return vals, valid & (pos <= hi) & (pos >= lo), av.dictionary
    if fn in (lp.WindowFn.LAG, lp.WindowFn.LEAD):
        av, sd, sv = arg(w.args[0])
        offset = const_int(w.args[1], 1) if len(w.args) > 1 else 1
        if fn is lp.WindowFn.LEAD:
            offset = -offset
        vals, valid = K.shift_in_segment(sd, sv, seg, offset)
        if len(w.args) > 2:
            dv, dd, dok = arg(w.args[2])
            if av.dictionary is not None or dv.dictionary is not None:
                raise ExecutionError(
                    "LAG/LEAD default over strings not supported yet")
            vals = torch.where(valid, vals, dd)
            valid = valid | dok
        return vals, valid, av.dictionary
    if fn in AGGREGATES:
        out_dict = None
        if w.args:
            av, vals, vok = arg(w.args[0])
            if av.dtype.kind is TypeKind.DECIMAL128 and fn is lp.WindowFn.AVG:
                # the mean of the values, not of their scaled integers
                vals = exact_div(vals.to(torch.float64),
                                 10.0 ** av.dtype.params[1])
            if fn in (lp.WindowFn.MIN, lp.WindowFn.MAX):
                out_dict = av.dictionary
            fname = fn.value.lower()
        else:
            vals = vok = None
            fname = "count_star"
        fdesc, plane = frame()
        out, valid = K.window_aggregate_sorted(
            fname, vals, vok, seg_change, peer_change, pad_sorted, fdesc,
            order_plane=plane)
        return out, valid, out_dict
    raise ExecutionError(f"window function {fn.value} not implemented")


def range_off_plane(w: lp.WindowExpr, arg):
    """The ORDER BY key of a RANGE offset frame in window order, DESC
    negated and NULLs at their sentinel (`K.range_off_order_plane`): there
    must be exactly one key, and a numeric one."""
    if len(w.order_by) != 1:
        raise ExecutionError(
            "RANGE offset frames require exactly one ORDER BY key")
    k0 = w.order_by[0]
    kv, kd, kok = arg(k0.expr)
    if kv.dictionary is not None or kv.data.dtype == torch.bool:
        raise ExecutionError(
            "RANGE offset frames require a numeric ORDER BY key")
    return K.range_off_order_plane(kd, kok, k0.asc, k0.resolved_nulls_first())
