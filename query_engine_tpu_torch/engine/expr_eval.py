"""Vectorized expression evaluation over a ColumnBatch.

The main-path subset of `query_engine_tpu.engine.expr_eval`: column
references, literals, comparisons, + - * /, AND/OR/NOT, unary minus,
IS [NOT] NULL and numeric CASTs, with the JAX package's semantics. Any other
expression raises NotImplementedError naming it.

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

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.columnar.batch import ColumnBatch, to_tensor
from query_engine_tpu_torch.columnar.dictionary import Dictionary
from query_engine_tpu_torch.plan import logical as lp


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
    dev = a.data.device
    ra_t = to_tensor(ra if len(ra) else np.zeros(1, np.int32), dev)
    rb_t = to_tensor(rb if len(rb) else np.zeros(1, np.int32), dev)
    a2 = Val(ra_t[a.data.long().clamp(0, max(len(da) - 1, 0))], a.validity,
             a.dtype, merged)
    b2 = Val(rb_t[b.data.long().clamp(0, max(len(db) - 1, 0))], b.validity,
             b.dtype, merged)
    return a2, b2


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
    """Evaluates LogicalExprs over a batch; literals are made on `device`."""

    def __init__(self, device="cpu", udfs=None):
        self.device = torch.device(device)
        self.udfs = udfs
        # while the compiled pipeline runs a program body: id(Literal) ->
        # 0-d tensor holding its value, so one program serves every value
        # of the literal (engine/pipeline.py)
        self._dyn_literals = None

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
            return self._eval_cast(e, batch)
        if isinstance(e, lp.IsNullExpr):
            v = self.eval(e.expr, batch)
            data = v.validity if e.negated else ~v.validity
            return Val(data, torch.ones(cap, dtype=torch.bool,
                                        device=self.device),
                       DataType.boolean())
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
        if op not in _CMP and op not in _ARITH:
            raise _unsupported(e)

        l = self.eval(e.left, batch)
        r = self.eval(e.right, batch)
        if TypeKind.DECIMAL128 in (l.dtype.kind, r.dtype.kind) or (
            (l.dtype.is_temporal and r.dictionary is not None)
            or (r.dtype.is_temporal and l.dictionary is not None)
        ):
            raise _unsupported(e)  # decimal scaling, temporal literals
        valid = l.validity & r.validity
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
        if t.is_dictionary and v.dictionary is not None:
            return Val(v.data, v.validity, t, v.dictionary)
        if (t.kind not in _NUMERIC_KINDS or v.dictionary is not None
                or v.dtype.kind is TypeKind.DECIMAL128):
            raise _unsupported(e)
        if t.kind is TypeKind.BOOLEAN:
            return Val(v.data.to(torch.bool), v.validity, t)
        return Val(v.data.to(_torch_dtype(t)), v.validity, t)
