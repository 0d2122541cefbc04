"""Vectorized expression evaluation over a ColumnBatch.

The subset of `query_engine_tpu.engine.expr_eval` that the main path and
the 22 TPC-H queries need: column references, literals, comparisons (a
DATE/TIMESTAMP against a string literal parses the literal), + - * /,
AND/OR/NOT, unary minus, IS [NOT] NULL, numeric CASTs and the
string-to-date/timestamp CAST, EXTRACT, SUBSTRING, CASE, [NOT] IN (list),
[NOT] [I]LIKE, and the subquery forms: scalar, [NOT] IN, [NOT] EXISTS,
ANY/ALL, and the planner's decorrelated lookups, with the JAX package's
semantics. Any other expression raises NotImplementedError naming it.

A subquery's plan runs through `subquery_exec` (the executor's `execute`),
once per evaluation; inside a compiled program body the pipeline has run it
beforehand and hands its result batch in through `_subplans`, so a program
never executes a plan.

Parity surface: reference crates/query-executor/src/operators.rs:13-848 —
arithmetic with per-type dispatch (:382-507), comparisons with numeric
coercion (:509-538,616-675), and/or/not (:539-570), literal broadcast
(:322-347).

Every result is (data plane, validity plane, optional host dictionary) on
the batch's device. Strings compare through a merged sorted dictionary, so
code order is string order.

Null semantics: SQL three-valued logic. Comparisons with NULL are NULL;
AND/OR follow Kleene logic; predicates treat NULL as false at filter time.
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.columnar.batch import ColumnBatch, to_tensor
from query_engine_tpu_torch.columnar.dictionary import Dictionary
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp


@dataclass
class Val:
    """An evaluated column: device planes + optional dictionary."""

    data: torch.Tensor
    validity: torch.Tensor
    dtype: DataType
    dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def _bcast(value, dtype: DataType, capacity: int, device) -> Val:
    ones = torch.ones(capacity, dtype=torch.bool, device=device)
    if value is None:
        return Val(
            torch.zeros(capacity, dtype=torch.int64, device=device),
            torch.zeros(capacity, dtype=torch.bool, device=device),
            dtype if dtype.kind is not TypeKind.NULL else DataType.null(),
        )
    if dtype.is_dictionary or isinstance(value, str):
        d, _ = Dictionary.from_values([value])
        return Val(torch.zeros(capacity, dtype=torch.int32, device=device),
                   ones, DataType.utf8(), d)
    if isinstance(value, bool):
        return Val(torch.full((capacity,), value, dtype=torch.bool,
                              device=device), ones, DataType.boolean())
    if isinstance(value, int) and not dtype.is_float:
        return Val(torch.full((capacity,), value, dtype=torch.int64,
                              device=device), ones, DataType.int64())
    return Val(torch.full((capacity,), float(value), dtype=torch.float64,
                          device=device), ones, DataType.float64())


def unify_dicts(a: Val, b: Val) -> Tuple[Val, Val]:
    """Remap two dictionary-encoded values onto a merged dictionary so code
    comparison == string comparison (dictionaries are sorted)."""
    da = a.dictionary or Dictionary.empty()
    db = b.dictionary or Dictionary.empty()
    merged, ra, rb = da.merge(db)
    return (Val(_code_table(ra, a), a.validity, a.dtype, merged),
            Val(_code_table(rb, b), b.validity, b.dtype, merged))


def _code_table(values: np.ndarray, v: Val) -> torch.Tensor:
    """values[code] per row: a host table of one entry per dictionary value
    (at least one entry), gathered by the row's code on v's device."""
    n = len(v.dictionary) if v.dictionary is not None else 0
    if len(values) == 0:
        values = np.zeros(1, dtype=values.dtype)
    table = to_tensor(values, v.data.device)
    return table[v.data.long().clamp(0, max(n - 1, 0))]


def _dict_lookup_host(v: Val, fn, np_dtype, out_dtype: DataType) -> Val:
    """One host value per dictionary entry, gathered by code on the device
    (one parse per distinct string, one gather per row)."""
    d = v.dictionary or Dictionary.empty()
    table = np.asarray([fn(x) for x in d.values], dtype=np_dtype)
    return Val(_code_table(table, v), v.validity, out_dtype)


def _dict_map_host(v: Val, fn, key) -> Val:
    """A host string function applied once per dictionary value (kept on
    the dictionary under `key`); the rows' codes are remapped into the
    (sorted) dictionary of the results by one gather on the device."""
    d = v.dictionary or Dictionary.empty()
    new_dict, remap = d.map_values(fn, key)
    return Val(_code_table(remap, v), v.validity, v.dtype, new_dict)


def like_to_regex(pattern: str, case_insensitive: bool) -> "re.Pattern":
    """SQL LIKE pattern -> anchored regex: % any run, _ one character,
    everything else literal."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$",
                      re.IGNORECASE if case_insensitive else 0)


_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_DT = datetime.datetime(1970, 1, 1)


def parse_temporal(text: str, kind: TypeKind) -> Optional[int]:
    """ISO text -> the lane value of a DATE32 (days), DATE64 (ms) or
    TIMESTAMP (us) column, or None when it does not parse."""
    try:
        if kind is TypeKind.DATE32:
            return (datetime.date.fromisoformat(text) - _EPOCH_DATE).days
        dt = datetime.datetime.fromisoformat(text)
        us = int((dt - _EPOCH_DT).total_seconds() * 1e6)
        return us if kind is TypeKind.TIMESTAMP else us // 1000
    except ValueError:
        return None


def _coerce_temporal_literal(l: Val, r: Val) -> Tuple[Val, Val]:
    """A temporal column against a one-value string dictionary (a literal):
    the literal parsed into the column's lane."""
    for a, b, flip in ((l, r, False), (r, l, True)):
        if a.dtype.is_temporal and b.dictionary is not None \
                and len(b.dictionary) == 1:
            parsed = parse_temporal(b.dictionary.values[0], a.dtype.kind)
            if parsed is not None:
                lit = Val(torch.full((b.capacity,), parsed, dtype=a.data.dtype,
                                     device=b.data.device),
                          b.validity, a.dtype)
                return (l, lit) if not flip else (lit, r)
    return l, r


_US_DAY = 86_400_000_000

# Howard Hinnant's days <-> civil date algorithms, exact over the whole
# proleptic Gregorian calendar; floor division (torch's // on integers)
# makes the era adjustments unconditional


def _civil_from_days(days: torch.Tensor):
    """days since 1970-01-01 -> (year, month, day), int64 planes."""
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    y = y - (m <= 2).to(torch.int64)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _temporal_split(v: Val):
    """-> (days since the epoch, microseconds into the day), int64."""
    k = v.dtype.kind
    data = v.data.to(torch.int64)
    if k is TypeKind.DATE32:
        return data, torch.zeros_like(data)
    if k is TypeKind.DATE64:
        days = data // 86_400_000
        return days, (data - days * 86_400_000) * 1000
    days = data // _US_DAY  # TIMESTAMP: microseconds
    return days, data - days * _US_DAY


_LIKE_OPS = {lp.BinOp.LIKE: (False, False), lp.BinOp.NOT_LIKE: (False, True),
             lp.BinOp.ILIKE: (True, False), lp.BinOp.NOT_ILIKE: (True, True)}


# the type of a program input literal, by the dtype of its tensor
_DYN_TYPES = {
    torch.bool: DataType.boolean,
    torch.int64: DataType.int64,
    torch.float64: DataType.float64,
}

_ARITH = {lp.BinOp.ADD, lp.BinOp.SUB, lp.BinOp.MUL, lp.BinOp.DIV}
_CMP = {
    lp.BinOp.EQ: torch.eq,
    lp.BinOp.NEQ: torch.ne,
    lp.BinOp.LT: torch.lt,
    lp.BinOp.LTE: torch.le,
    lp.BinOp.GT: torch.gt,
    lp.BinOp.GTE: torch.ge,
}

# CAST targets the subset evaluates: fixed-width numbers and booleans
_NUMERIC_KINDS = {
    TypeKind.BOOLEAN, TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
    TypeKind.INT64, TypeKind.UINT8, TypeKind.UINT16, TypeKind.UINT32,
    TypeKind.UINT64, TypeKind.FLOAT32, TypeKind.FLOAT64,
}


def temporal_literal(
        e: lp.LogicalExpr) -> Optional[Tuple[lp.LogicalExpr, int]]:
    """(node, lane value) when evaluating node `e` parses a string literal
    into a date or timestamp lane, else None. In a comparison of a temporal
    value with a string literal (`d < '1995-03-15'`, either way round;
    `_coerce_temporal_literal`) the node is the literal; in `CAST('1995-01-01'
    AS DATE)` (what `DATE '...'` plans to; `_eval_cast`) it is the cast."""
    if isinstance(e, lp.BinaryExpr) and e.op in _CMP:
        for a, b in ((e.left, e.right), (e.right, e.left)):
            if (a.dtype.is_temporal and isinstance(b, lp.Literal)
                    and isinstance(b.value.value, str)):
                v = parse_temporal(b.value.value, a.dtype.kind)
                if v is not None:
                    return b, v
    elif (isinstance(e, lp.CastExpr) and e.target.is_temporal
          and isinstance(e.expr, lp.Literal)
          and isinstance(e.expr.value.value, str)):
        v = parse_temporal(e.expr.value.value, e.target.kind)
        if v is not None:
            return e, v
    return None


def builds_host_table(e: lp.LogicalExpr) -> bool:
    """True when evaluating `e` builds a table on the host and copies it to
    the device: the merged-dictionary code remap of a string comparison or
    string IN (`unify_dicts`), LIKE's per-value match table (`_eval_like`),
    a CASE with string results (`_eval_case`), a string cast to a date that
    is not a literal (`_eval_cast`), SUBSTRING's per-value map
    (`_dict_map_host`), and the code remap of an IN or ANY/ALL subquery or
    a correlated lookup whose keys are strings. A date literal
    (`temporal_literal`) is not among them."""
    found = []

    def visit(x):
        if isinstance(x, (lp.InSubqueryExpr, lp.QuantifiedCmpExpr)):
            if x.expr.dtype.is_dictionary or \
                    x.plan.schema().field(0).data_type.is_dictionary:
                found.append(x)
        elif isinstance(x, lp.CorrelatedLookupExpr):
            fields = x.plan.schema().fields
            if any(k.dtype.is_dictionary or f.data_type.is_dictionary
                   for k, f in zip(x.outer_keys, fields)):
                found.append(x)
        elif isinstance(x, lp.ScalarFnExpr) \
                and x.func is lp.ScalarFn.SUBSTRING:
            found.append(x)
        if isinstance(x, lp.BinaryExpr):
            if (x.left.dtype.is_dictionary or x.right.dtype.is_dictionary) \
                    and temporal_literal(x) is None:
                found.append(x)
        elif isinstance(x, lp.InListExpr):
            if x.expr.dtype.is_dictionary or any(
                    i.dtype.is_dictionary for i in x.items):
                found.append(x)
        elif isinstance(x, lp.CaseExpr):
            if x.dtype.is_dictionary:
                found.append(x)
        elif isinstance(x, lp.CastExpr):
            if x.target.is_temporal and x.expr.dtype.is_dictionary \
                    and temporal_literal(x) is None:
                found.append(x)

    lp.walk_exprs(e, visit)
    return bool(found)


def _unsupported(e: lp.LogicalExpr) -> NotImplementedError:
    return NotImplementedError(
        f"query_engine_tpu_torch does not evaluate {type(e).__name__} "
        f"({e.name()}) yet"
    )


def _torch_dtype(t: DataType) -> torch.dtype:
    """Torch dtype of a type's plane, as columnar.batch.to_tensor makes it
    (unsigned planes wider than 8 bits ride as int64)."""
    return to_tensor(np.zeros(0, dtype=t.device_dtype), "cpu").dtype


class Evaluator:
    """Evaluates LogicalExprs over a batch; literals are made on `device`.
    `subquery_exec` (physical plan -> ColumnBatch) runs a subquery's plan;
    the executor supplies its own `execute`."""

    def __init__(self, device="cpu", udfs=None, subquery_exec=None):
        self.device = torch.device(device)
        self.udfs = udfs
        self.subquery_exec = subquery_exec
        # per query: the rank match of an outer batch's keys against a
        # shared (multiply referenced) subplan's keys, which several
        # correlated lookups rooted at one shared aggregate repeat (Q21's
        # EXISTS and MIN/MAX bounds); the Session clears it around a query
        self._corr_match_memo = {}
        # while the compiled pipeline runs a program body: id(Literal) ->
        # 0-d tensor holding its value, so one program serves every value
        # of the literal (engine/pipeline.py)
        self._dyn_literals = None
        # while the compiled pipeline runs a program body: id(subplan) ->
        # the batch the pipeline materialized for it before the program ran
        self._subplans = None

    # ---- public --------------------------------------------------------
    def eval(self, e: lp.LogicalExpr, batch: ColumnBatch) -> Val:
        cap = batch.capacity
        if isinstance(e, lp.ColumnRef):
            col = batch.columns[e.index]
            return Val(col.data, col.validity, e.dtype, col.dictionary)
        if isinstance(e, lp.Literal):
            if self._dyn_literals is not None:
                dv = self._dyn_literals.get(id(e))
                if dv is not None:
                    return Val(dv.expand(cap), torch.ones(
                        cap, dtype=torch.bool, device=dv.device),
                        _DYN_TYPES[dv.dtype]())
            return _bcast(e.value.value, e.value.dtype, cap, self.device)
        if isinstance(e, lp.AliasExpr):
            return self.eval(e.expr, batch)
        if isinstance(e, lp.BinaryExpr):
            return self._eval_binary(e, batch)
        if isinstance(e, lp.UnaryExpr):
            v = self.eval(e.expr, batch)
            if e.op is lp.UnOp.NOT:
                return Val(~v.data.to(torch.bool), v.validity,
                           DataType.boolean())
            if v.dictionary is not None:
                raise _unsupported(e)
            return Val(-v.data, v.validity, v.dtype)
        if isinstance(e, lp.CastExpr):
            if self._dyn_literals is not None:
                # a string literal cast to a date/timestamp, parsed when the
                # program was keyed (temporal_literal)
                dv = self._dyn_literals.get(id(e))
                if dv is not None:
                    return Val(dv.expand(cap).to(_torch_dtype(e.target)),
                               torch.ones(cap, dtype=torch.bool,
                                          device=dv.device), e.target)
            return self._eval_cast(e, batch)
        if isinstance(e, lp.ScalarFnExpr):
            if e.func is lp.ScalarFn.EXTRACT:
                return self._eval_extract(e, batch)
            if e.func is lp.ScalarFn.SUBSTRING:
                return self._eval_substring(e, batch)
            raise _unsupported(e)
        if isinstance(e, lp.CaseExpr):
            return self._eval_case(e, batch)
        if isinstance(e, lp.InListExpr):
            return self._eval_in_list(e, batch)
        if isinstance(e, lp.IsNullExpr):
            v = self.eval(e.expr, batch)
            data = v.validity if e.negated else ~v.validity
            return Val(data, torch.ones(cap, dtype=torch.bool,
                                        device=self.device),
                       DataType.boolean())
        if isinstance(e, lp.ScalarSubqueryExpr):
            return self._eval_scalar_subquery(e, batch)
        if isinstance(e, lp.InSubqueryExpr):
            return self._eval_in_subquery(e, batch)
        if isinstance(e, lp.QuantifiedCmpExpr):
            return self._eval_quantified_cmp(e, batch)
        if isinstance(e, lp.ExistsExpr):
            return self._eval_exists(e, batch)
        if isinstance(e, lp.CorrelatedLookupExpr):
            return self._eval_correlated_lookup(e, batch)
        if isinstance(e, lp.AggregateExpr):
            raise ExecutionError(
                "aggregate expression outside aggregation context"
            )
        raise _unsupported(e)

    def eval_predicate_mask(self, e: lp.LogicalExpr, batch: ColumnBatch):
        """Predicate -> boolean mask; NULL -> excluded (SQL WHERE)."""
        v = self.eval(e, batch)
        return v.data.to(torch.bool) & v.validity

    # ---- binary --------------------------------------------------------
    def _eval_binary(self, e: lp.BinaryExpr, batch: ColumnBatch) -> Val:
        op = e.op
        if op in (lp.BinOp.AND, lp.BinOp.OR):
            l = self.eval(e.left, batch)
            r = self.eval(e.right, batch)
            ld, rd = l.data.to(torch.bool), r.data.to(torch.bool)
            if op is lp.BinOp.AND:
                data = ld & rd
                # Kleene: false AND anything = false (valid)
                valid = (l.validity & r.validity) | (l.validity & ~ld) | (
                    r.validity & ~rd
                )
            else:
                data = ld | rd
                valid = (l.validity & r.validity) | (l.validity & ld) | (
                    r.validity & rd
                )
            return Val(data, valid, DataType.boolean())
        if op in _LIKE_OPS:
            return self._eval_like(e, batch)
        if op not in _CMP and op not in _ARITH:
            raise _unsupported(e)

        l = self.eval(e.left, batch)
        r = self.eval(e.right, batch)
        if TypeKind.DECIMAL128 in (l.dtype.kind, r.dtype.kind):
            raise _unsupported(e)  # decimal scaling
        valid = l.validity & r.validity
        # temporal column vs string literal: parse the literal as a date or
        # timestamp, so WHERE d > '2024-01-01' compares days with days
        l, r = _coerce_temporal_literal(l, r)
        if (l.dtype.is_temporal and r.dictionary is not None) or (
                r.dtype.is_temporal and l.dictionary is not None):
            raise ExecutionError(
                f"cannot compare a {l.dtype if l.dtype.is_temporal else r.dtype}"
                f" value with a string that is not a date: {e.name()}")
        if l.dictionary is not None or r.dictionary is not None:
            # string comparison via merged sorted dictionary -> code compare
            if op not in _CMP:
                raise ExecutionError(
                    f"operator {op.value} not valid for strings"
                )
            l2, r2 = unify_dicts(l, r)
            ld, rd = l2.data, r2.data
        elif l.dtype.is_float or r.dtype.is_float:
            ld, rd = l.data.to(torch.float64), r.data.to(torch.float64)
        elif l.dtype.kind is TypeKind.BOOLEAN and r.dtype.kind is TypeKind.BOOLEAN:
            ld, rd = l.data, r.data
        else:
            ld, rd = l.data.to(torch.int64), r.data.to(torch.int64)

        if op in _CMP:
            return Val(_CMP[op](ld, rd), valid, DataType.boolean())

        if op is lp.BinOp.ADD:
            data = ld + rd
        elif op is lp.BinOp.SUB:
            data = ld - rd
        elif op is lp.BinOp.MUL:
            data = ld * rd
        elif not ld.is_floating_point():  # DIV on integers
            # SQL integer division truncates toward zero (Arrow/PG);
            # div-by-zero yields NULL (PG raises; NULL keeps the
            # vectorized path total — documented deviation)
            zero = rd == 0
            data = torch.div(torch.where(zero, 0, ld),
                             torch.where(zero, 1, rd), rounding_mode="trunc")
            valid = valid & ~zero
        else:
            zero = rd == 0.0
            data = ld / torch.where(zero, 1.0, rd)
            valid = valid & ~zero
        return Val(data, valid, e.dtype)

    # ---- cast ----------------------------------------------------------
    def _eval_cast(self, e: lp.CastExpr, batch: ColumnBatch) -> Val:
        v = self.eval(e.expr, batch)
        t = e.target
        if v.dtype.kind is TypeKind.NULL:  # CAST(NULL AS t): all NULL
            cap = v.data.shape[0]
            return Val(
                torch.zeros(cap, dtype=torch.int32 if t.is_dictionary
                            else _torch_dtype(t), device=v.data.device),
                torch.zeros(cap, dtype=torch.bool, device=v.data.device), t,
                Dictionary.empty() if t.is_dictionary else None)
        if t.is_dictionary and v.dictionary is not None:
            return Val(v.data, v.validity, t, v.dictionary)
        if t.is_temporal and v.dictionary is not None:
            # string -> date/timestamp: one ISO parse per dictionary value;
            # a string that does not parse gives NULL
            sentinel = np.iinfo(np.int64).min

            def parse(s):
                p = parse_temporal(s, t.kind)
                return sentinel if p is None else p

            tv = _dict_lookup_host(v, parse, np.int64, t)
            bad = tv.data == sentinel
            return Val(tv.data.to(_torch_dtype(t)), tv.validity & ~bad, t)
        if (t.kind not in _NUMERIC_KINDS or v.dictionary is not None
                or v.dtype.kind is TypeKind.DECIMAL128):
            raise _unsupported(e)
        if t.kind is TypeKind.BOOLEAN:
            return Val(v.data.to(torch.bool), v.validity, t)
        return Val(v.data.to(_torch_dtype(t)), v.validity, t)

    # ---- LIKE ------------------------------------------------------------
    def _eval_like(self, e: lp.BinaryExpr, batch: ColumnBatch) -> Val:
        """[NOT] [I]LIKE against a literal pattern: one regex match per
        dictionary value on the host, then a gather by code on the device."""
        l = self.eval(e.left, batch)
        r = self.eval(e.right, batch)
        if l.dictionary is None or r.dictionary is None \
                or len(r.dictionary) != 1:
            raise ExecutionError(
                f"{e.op.value} requires a string column and a literal pattern"
            )
        ci, neg = _LIKE_OPS[e.op]
        rx = like_to_regex(r.dictionary.values[0], ci)
        table = np.asarray([bool(rx.match(x)) for x in l.dictionary.values],
                           dtype=bool)
        data = _code_table(table, l)
        if neg:
            data = ~data
        return Val(data, l.validity & r.validity, DataType.boolean())

    # ---- EXTRACT ---------------------------------------------------------
    def _eval_extract(self, e: lp.ScalarFnExpr, batch: ColumnBatch) -> Val:
        """EXTRACT(field FROM temporal), with PostgreSQL's fields: dow
        0=Sunday..6, isodow 1=Monday..7, week the ISO 8601 week; second and
        epoch are float64 with the fraction, the others int64."""
        f_expr, t_expr = e.args
        if isinstance(f_expr, lp.Literal) and isinstance(f_expr.value.value,
                                                         str):
            field = f_expr.value.value.lower()
            f_valid = None
        else:
            fv = self.eval(f_expr, batch)
            if fv.dictionary is None or len(fv.dictionary) != 1:
                raise ExecutionError("EXTRACT requires a string literal field")
            field, f_valid = fv.dictionary.values[0].lower(), fv.validity
        v = self.eval(t_expr, batch)
        if not v.dtype.is_temporal:
            raise ExecutionError(
                f"EXTRACT needs a date/timestamp argument, got {v.dtype}"
            )
        days, tod = _temporal_split(v)
        valid = v.validity if f_valid is None else v.validity & f_valid
        if field in ("year", "month", "day", "quarter", "decade", "century",
                     "millennium"):
            y, m, d = _civil_from_days(days)
            out = {
                "year": y, "month": m, "day": d,
                "quarter": (m - 1) // 3 + 1,
                "decade": y // 10,
                "century": (y + 99) // 100,
                "millennium": (y + 999) // 1000,
            }[field]
        elif field == "dow":
            out = (days + 4) % 7
        elif field == "isodow":
            out = (days + 3) % 7 + 1
        elif field == "doy":
            y, _, _ = _civil_from_days(days)
            one = torch.ones_like(y)
            out = days - _days_from_civil(y, one, one) + 1
        elif field == "week":
            # ISO week: the week holding this date's Thursday
            thursday = days - (days + 3) % 7 + 3
            ty, _, _ = _civil_from_days(thursday)
            one = torch.ones_like(ty)
            out = (thursday - _days_from_civil(ty, one, one)) // 7 + 1
        elif field == "hour":
            out = tod // 3_600_000_000
        elif field == "minute":
            out = (tod // 60_000_000) % 60
        elif field == "second":
            return Val((tod % 60_000_000).to(torch.float64) / 1e6, valid,
                       DataType.float64())
        elif field == "epoch":
            sec = days.to(torch.float64) * 86400.0 + tod.to(torch.float64) / 1e6
            return Val(sec, valid, DataType.float64())
        elif field == "milliseconds":
            out = tod % 60_000_000 // 1000
        elif field == "microseconds":
            out = tod % 60_000_000
        else:
            raise ExecutionError(f"EXTRACT field '{field}' not supported")
        return Val(out.to(torch.int64), valid, DataType.int64())

    # ---- SUBSTRING -------------------------------------------------------
    @staticmethod
    def _static_num(expr: lp.LogicalExpr, val: Val):
        """A numeric argument the host needs (SUBSTRING's start and length),
        read from the expression node when it is a (negated) literal, else
        from the evaluated value's first row (a device read)."""
        x, neg = expr, False
        while isinstance(x, (lp.AliasExpr, lp.UnaryExpr)):
            if isinstance(x, lp.UnaryExpr):
                if x.op is not lp.UnOp.NEG:
                    break
                neg = not neg
            x = x.expr
        if isinstance(x, lp.Literal) and x.value.value is not None \
                and not isinstance(x.value.value, str):
            v = x.value.value
            return -v if neg else v
        return val.data[0].item()

    def _eval_substring(self, e: lp.ScalarFnExpr, batch: ColumnBatch) -> Val:
        """SUBSTRING(s, start[, length]), 1-based, over the dictionary on
        the host: one slice per distinct string, one gather per row."""
        args = [self.eval(a, batch) for a in e.args]
        start = int(self._static_num(e.args[1], args[1]))
        length = (int(self._static_num(e.args[2], args[2]))
                  if len(args) > 2 else None)
        lo = max(start - 1, 0)

        def sub(s):
            return s[lo:lo + length] if length is not None else s[lo:]

        return _dict_map_host(args[0], sub, ("SUBSTRING", lo, length))

    # ---- subqueries ------------------------------------------------------
    @staticmethod
    def _shared_root_id(p):
        """id() of the shared (multiply referenced) physical subplan a
        lookup's plan is rooted at, else None. Walks only the row-preserving
        wrappers (PSubquery renames, PProjection)."""
        while p is not None:
            if isinstance(p, pp.PSubquery):
                return id(p.input) if p.shared else None
            if not isinstance(p, pp.PProjection):
                return None
            p = p.input
        return None

    def _run_subplan(self, plan) -> ColumnBatch:
        """The subquery's result batch: inside a program body the one the
        pipeline fed in, else the plan run now. A plan never runs while a
        CUDA stream captures a graph."""
        if self._subplans is not None:
            sub = self._subplans.get(id(plan))
            if sub is None:
                raise ExecutionError("a subquery's batch was not fed to the "
                                     "program that reads it")
            return sub
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a subquery plan would run inside a CUDA "
                               "graph capture")
        if self.subquery_exec is None:
            raise ExecutionError("subquery execution not available here")
        return self.subquery_exec(plan)

    def _eval_scalar_subquery(self, e: lp.ScalarSubqueryExpr,
                              batch: ColumnBatch) -> Val:
        """The first row's value broadcast to every row; NULL when the
        subquery returned no rows. No device read."""
        sub = self._run_subplan(e.plan)
        col = sub.columns[0]
        cap = batch.capacity
        has = K.live_mask(sub.capacity, sub.num_rows, col.data.device)[0]
        return Val(col.data[0].expand(cap), (has & col.validity[0]).expand(cap),
                   e.dtype, col.dictionary)

    def _sub_column(self, v: Val, scol):
        """(probe, build) planes of a value against a subquery column:
        dictionary codes remapped onto one merged dictionary, else float64
        when either side is a float, else int64."""
        if v.dictionary is not None or scol.dictionary is not None:
            sval = Val(scol.data, scol.validity, DataType.utf8(),
                       scol.dictionary)
            v2, s2 = unify_dicts(v, sval)
            return v2.data.to(torch.int64), s2.data.to(torch.int64)
        t = torch.float64 if (v.dtype.is_float or scol.dtype.is_float) \
            else torch.int64
        return v.data.to(t), scol.data.to(t)

    def _eval_in_subquery(self, e: lp.InSubqueryExpr,
                          batch: ColumnBatch) -> Val:
        """x [NOT] IN (subquery), three-valued: TRUE when x is among the
        subquery's values; NULL when x is NULL, or when x is not found and
        the subquery holds a NULL; else FALSE. NOT IN negates the value and
        keeps the NULLs."""
        sub = self._run_subplan(e.plan)
        v = self.eval(e.expr, batch)
        scol = sub.columns[0]
        probe, build = self._sub_column(v, scol)
        lm = K.live_mask(sub.capacity, sub.num_rows, build.device)
        sub_has_null = (lm & ~scol.validity).any()
        lr, rr = K.join_ranks([(probe, v.validity)], [(build, scol.validity)],
                              batch.num_rows, sub.num_rows)
        found = K.rank_member(lr, rr, lm)
        valid = v.validity & (found | ~sub_has_null)
        return Val(~found if e.negated else found, valid, DataType.boolean())

    def _eval_quantified_cmp(self, e: lp.QuantifiedCmpExpr,
                             batch: ColumnBatch) -> Val:
        """x op ANY|ALL (S): S reduces to the MIN and MAX of its non-NULL
        values, with PostgreSQL's three-valued logic. x > ANY(S) <=> x >
        MIN(S); x > ALL(S) <=> x > MAX(S); <> ANY and = ALL test both
        extremes. ANY is TRUE when the extreme test passes, FALSE when it
        fails with no NULL in play, else NULL; over an empty S it is FALSE
        even for a NULL x. ALL mirrors it with TRUE and FALSE swapped, and is
        TRUE over an empty S. (= ANY and <> ALL are planned as [NOT] IN.)"""
        sub = self._run_subplan(e.plan)
        v = self.eval(e.expr, batch)
        scol = sub.columns[0]
        svalid = scol.validity
        if v.dictionary is not None and scol.dictionary is not None:
            # sorted dictionaries: code order is string order
            x, sd = self._sub_column(v, scol)
        elif v.dictionary is not None or scol.dictionary is not None:
            # strings against non-strings: legal only when the string side
            # holds no value (an all-NULL column types as utf8 with an
            # empty dictionary), so it contributes only NULLs
            strside = v if v.dictionary is not None else scol
            if any(s != "" for s in strside.dictionary.values):
                raise ExecutionError(
                    "cannot compare string and non-string in ANY/ALL")
            if v.dictionary is not None:
                x = torch.zeros(v.data.shape, dtype=torch.int64,
                                device=v.data.device)
                v = Val(v.data, torch.zeros_like(v.validity), v.dtype)
                sd = scol.data.to(torch.int64)
            else:
                x = v.data.to(torch.int64)
                sd = torch.zeros(scol.data.shape, dtype=torch.int64,
                                 device=scol.data.device)
                svalid = torch.zeros_like(svalid)
        else:
            x, sd = self._sub_column(v, scol)
        lm = K.live_mask(sub.capacity, sub.num_rows, sd.device)
        nn = lm & svalid
        nonempty = lm.any()
        has_nonnull = nn.any()
        has_null = (lm & ~svalid).any()
        big = (torch.finfo(sd.dtype).max if sd.is_floating_point()
               else torch.iinfo(sd.dtype).max)
        mn = torch.where(nn, sd, torch.full_like(sd, big)).min()
        mx = torch.where(nn, sd, torch.full_like(sd, -big)).max()
        O = lp.BinOp
        if e.is_any:
            cand = {
                O.GT: lambda: x > mn, O.GTE: lambda: x >= mn,
                O.LT: lambda: x < mx, O.LTE: lambda: x <= mx,
                O.NEQ: lambda: (x != mn) | (x != mx),
            }[e.op]()
            true_m = v.validity & has_nonnull & cand
            false_m = ~nonempty | (v.validity & ~has_null & has_nonnull
                                   & ~cand)
            return Val(true_m, true_m | false_m, DataType.boolean())
        cand = {
            O.GT: lambda: x > mx, O.GTE: lambda: x >= mx,
            O.LT: lambda: x < mn, O.LTE: lambda: x <= mn,
            O.EQ: lambda: (x == mn) & (x == mx),
        }[e.op]()
        true_m = ~nonempty | (v.validity & ~has_null & has_nonnull & cand)
        false_m = v.validity & has_nonnull & ~cand
        return Val(true_m, true_m | false_m, DataType.boolean())

    def _eval_correlated_lookup(self, e: lp.CorrelatedLookupExpr,
                                batch: ColumnBatch) -> Val:
        """A decorrelated subquery: its grouped subplan runs once, the outer
        batch's key expressions are rank-matched against its key columns
        (unique per group), and the value column (or, for EXISTS, the found
        mask) is gathered per outer row. Never one execution per row."""
        sub = self._run_subplan(e.plan)
        nk = len(e.outer_keys)
        mkey = None
        if self._subplans is None:  # eager only: a program keeps no memo
            sid = self._shared_root_id(e.plan)
            if sid is not None:
                mkey = (id(batch), sid, tuple(id(k) for k in e.outer_keys))
        hit = self._corr_match_memo.get(mkey) if mkey is not None else None
        if hit is not None:
            _, row, found = hit
        else:
            okeys, skeys = [], []
            for i, ke in enumerate(e.outer_keys):
                ov = self.eval(ke, batch)
                sc = sub.columns[i]
                sv = Val(sc.data, sc.validity, sc.dtype, sc.dictionary)
                if ov.dictionary is not None or sv.dictionary is not None:
                    ov, sv = unify_dicts(ov, sv)
                okeys.append((ov.data, ov.validity))
                skeys.append((sv.data, sv.validity))
            lr, rr = K.join_ranks(okeys, skeys, batch.num_rows, sub.num_rows)
            row, found = K.fk_join_right_lookup(lr, rr, batch.num_rows,
                                                sub.num_rows)
            if mkey is not None:
                # the batch rides along so its id stays its own
                self._corr_match_memo[mkey] = (batch, row, found)
        if e.mode == "exists":
            return Val(~found if e.negated else found,
                       torch.ones(batch.capacity, dtype=torch.bool,
                                  device=found.device), DataType.boolean())
        vcol = sub.columns[nk]
        data = vcol.data[row]
        valid = found & vcol.validity[row]
        if e.miss_value is not None and e.miss_value.value is not None:
            data = torch.where(found, data, torch.full_like(
                data, e.miss_value.value))
            valid = valid | ~found
        return Val(data, valid, e.dtype, vcol.dictionary)

    def _eval_exists(self, e: lp.ExistsExpr, batch: ColumnBatch) -> Val:
        """[NOT] EXISTS (uncorrelated subquery): whether it has a row, for
        every outer row; never NULL."""
        sub = self._run_subplan(e.plan)
        ref = sub.columns[0].data if sub.columns else None
        dev = ref.device if ref is not None else self.device
        hit = K.live_mask(sub.capacity, sub.num_rows, dev)[0]
        if e.negated:
            hit = ~hit
        return Val(hit.expand(batch.capacity),
                   torch.ones(batch.capacity, dtype=torch.bool, device=dev),
                   DataType.boolean())

    # ---- CASE / IN -------------------------------------------------------
    def _eval_case(self, e: lp.CaseExpr, batch: ColumnBatch) -> Val:
        """Searched CASE (a simple CASE arrives as equality conditions): the
        first branch whose condition is true (NULL is not true) gives the
        value; no such branch gives ELSE, or NULL without one. String
        results share one merged dictionary."""
        conds = [self.eval(c, batch) for c, _ in e.branches]
        thens = [self.eval(t, batch) for _, t in e.branches]
        else_v = None if e.else_expr is None else self.eval(e.else_expr,
                                                            batch)
        vals = thens + ([else_v] if else_v is not None else [])
        out_dict = None
        if any(v.dictionary is not None for v in vals):
            merged = vals[0].dictionary or Dictionary.empty()
            for v in vals[1:]:
                merged, _, _ = merged.merge(v.dictionary or Dictionary.empty())
            remapped = []
            for v in vals:
                d = v.dictionary or Dictionary.empty()
                rm = np.searchsorted(merged.values, d.values).astype(np.int32)
                remapped.append(Val(_code_table(rm, v), v.validity, v.dtype,
                                    merged))
            thens = remapped[:len(thens)]
            else_v = remapped[len(thens)] if else_v is not None else None
            out_dict = merged
        if else_v is not None:
            data, valid = else_v.data, else_v.validity
        else:
            data = torch.zeros_like(thens[0].data)
            valid = torch.zeros(batch.capacity, dtype=torch.bool,
                                device=data.device)
        for c, t in reversed(list(zip(conds, thens))):
            hit = c.data.to(torch.bool) & c.validity
            data = torch.where(hit, t.data, data)
            valid = torch.where(hit, t.validity, valid)
        return Val(data, valid, e.dtype, out_dict)

    def _eval_in_list(self, e: lp.InListExpr, batch: ColumnBatch) -> Val:
        """x IN (a, b, ...) == (x = a) OR (x = b) OR ..., three-valued: no
        match with a NULL on either side is NULL. NOT IN negates it."""
        acc = None
        for item in e.items:
            cmp = self._eval_binary(lp.BinaryExpr(e.expr, lp.BinOp.EQ, item),
                                    batch)
            if acc is None:
                acc = cmp
                continue
            data = acc.data | cmp.data
            valid = (acc.validity & cmp.validity) | (acc.validity & acc.data) \
                | (cmp.validity & cmp.data)
            acc = Val(data, valid, DataType.boolean())
        if e.negated:
            acc = Val(~acc.data, acc.validity, DataType.boolean())
        return acc
