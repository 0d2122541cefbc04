"""Physical plan nodes.

Parity surface: reference crates/query-executor/src/physical_plan.rs:8-247 —
Scan, Projection, Filter, HashJoin, HashAggregate, Sort, Limit, SubqueryScan,
Window, IndexScan, and the `DataSource` trait (scan()->batches, schema()).

Expressions are the typed LogicalExpr IR from plan/logical.py — it is already
column-index-resolved and typed, so a second isomorphic expression tree (the
reference's PhysicalExpr) would add nothing; the lowering pass instead
rewrites subquery expressions to carry *physical* subplans.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Tuple

from query_engine_tpu_torch.core.schema import Schema
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.plan import logical as lp


class DataSource(Protocol):
    """Storage interface (reference physical_plan.rs:8-11)."""

    def scan(self) -> ColumnBatch: ...

    def schema(self) -> Schema: ...


class PhysicalPlan:
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> List["PhysicalPlan"]:
        return []

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [pad + self._label()]
        for c in self.children():
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    def _label(self) -> str:
        return type(self).__name__


@dataclass
class PScan(PhysicalPlan):
    table_name: str
    source: object  # DataSource
    out_schema: Schema  # prefixed names (already projected)
    projection: Optional[List[int]] = None  # source column indices to keep

    def schema(self) -> Schema:
        return self.out_schema

    def _label(self):
        proj = "" if self.projection is None else f" projection={self.projection}"
        return f"Scan: {self.table_name}{proj}"


@dataclass
class PIndexScan(PhysicalPlan):
    table_name: str
    source: object
    out_schema: Schema
    index_name: str
    # host-side lookup callback returning row ids (set by lowering)
    lookup: object = None
    residual: Optional[lp.LogicalExpr] = None
    projection: Optional[List[int]] = None

    def schema(self) -> Schema:
        return self.out_schema

    def _label(self):
        return f"IndexScan: {self.table_name} via {self.index_name}"


@dataclass
class PProjection(PhysicalPlan):
    input: PhysicalPlan
    exprs: List[lp.LogicalExpr]

    def schema(self) -> Schema:
        from query_engine_tpu_torch.core.schema import Field

        return Schema([Field(e.name(), e.dtype, e.nullable) for e in self.exprs])

    def children(self):
        return [self.input]

    def _label(self):
        return f"Projection: {', '.join(e.name() for e in self.exprs)}"


@dataclass
class PFilter(PhysicalPlan):
    input: PhysicalPlan
    predicate: lp.LogicalExpr

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def _label(self):
        return f"Filter: {self.predicate.name()}"


@dataclass
class PHashJoin(PhysicalPlan):
    left: PhysicalPlan
    right: PhysicalPlan
    join_type: lp.JoinType
    key_pairs: List[Tuple[lp.LogicalExpr, lp.LogicalExpr]]  # left-scope, right-scope
    residual: Optional[lp.LogicalExpr]  # over merged schema
    out_schema: Schema

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.left, self.right]

    def _label(self):
        ks = ", ".join(f"{l.name()}={r.name()}" for l, r in self.key_pairs)
        return f"HashJoin: {self.join_type.value} on [{ks}]"


@dataclass
class PHashAggregate(PhysicalPlan):
    input: PhysicalPlan
    group_exprs: List[lp.LogicalExpr]
    agg_exprs: List[lp.AggregateExpr]
    mode: str = "single"  # single | partial | final (distributed two-phase,
    # the reference's partial+final stage split planner.rs:200-226)

    def schema(self) -> Schema:
        from query_engine_tpu_torch.core.schema import Field
        from query_engine_tpu_torch.core.types import DataType

        fields = [Field(e.name(), e.dtype, e.nullable) for e in self.group_exprs]
        if self.mode == "partial":
            for e in self.agg_exprs:
                if e.func is lp.AggFunc.AVG:
                    fields.append(Field(e.name() + "__sum", DataType.float64(), True))
                    fields.append(Field(e.name() + "__cnt", DataType.int64(), False))
                else:
                    fields.append(Field(e.name(), e.dtype, e.nullable))
        else:
            fields += [Field(e.name(), e.dtype, e.nullable) for e in self.agg_exprs]
        return Schema(fields)

    def children(self):
        return [self.input]

    def _label(self):
        g = ", ".join(e.name() for e in self.group_exprs)
        a = ", ".join(e.name() for e in self.agg_exprs)
        return f"HashAggregate[{self.mode}]: group=[{g}] aggr=[{a}]"


@dataclass
class PSort(PhysicalPlan):
    input: PhysicalPlan
    keys: List[lp.SortKey]

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def _label(self):
        ks = ", ".join(
            f"{k.expr.name()} {'ASC' if k.asc else 'DESC'}" for k in self.keys
        )
        return f"Sort: {ks}"


@dataclass
class PLimit(PhysicalPlan):
    input: PhysicalPlan
    skip: int = 0
    fetch: Optional[int] = None

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def _label(self):
        return f"Limit: skip={self.skip} fetch={self.fetch}"


@dataclass
class PWindow(PhysicalPlan):
    input: PhysicalPlan
    window_exprs: List[lp.WindowExpr]
    names: List[str]

    def schema(self) -> Schema:
        from query_engine_tpu_torch.core.schema import Field

        fields = list(self.input.schema().fields)
        fields += [
            Field(n, e.dtype, e.nullable)
            for n, e in zip(self.names, self.window_exprs)
        ]
        return Schema(fields)

    def children(self):
        return [self.input]

    def _label(self):
        return f"Window: {', '.join(self.names)}"


@dataclass
class PDistinct(PhysicalPlan):
    input: PhysicalPlan
    on: Optional[List[lp.LogicalExpr]] = None

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]


@dataclass
class PSetOp(PhysicalPlan):
    left: PhysicalPlan
    right: PhysicalPlan
    kind: lp.SetOpKind

    def schema(self) -> Schema:
        return self.left.schema()

    def children(self):
        return [self.left, self.right]

    def _label(self):
        return f"SetOp: {self.kind.value}"


@dataclass
class PSubquery(PhysicalPlan):
    input: PhysicalPlan
    out_schema: Schema
    alias: str = ""
    # True when `input` is a WITH query shared by multiple references: the
    # executor materializes it once per query and every reference reuses
    # the same batch (compiled/mesh pipelines treat it as a leaf boundary)
    shared: bool = False

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.input]

    def _label(self):
        return f"SubqueryScan: {self.alias}"


@dataclass
class PEmpty(PhysicalPlan):
    out_schema: Schema
    produce_one_row: bool = False

    def schema(self) -> Schema:
        return self.out_schema


@dataclass
class PValues(PhysicalPlan):
    rows: List[List[lp.LogicalExpr]]
    out_schema: Schema

    def schema(self) -> Schema:
        return self.out_schema


@dataclass
class PUnnest(PhysicalPlan):
    input: PhysicalPlan
    list_expr: lp.LogicalExpr
    out_schema: Schema

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.input]

    def _label(self):
        return f"Unnest: {self.list_expr.name()}"


@dataclass
class PGenerateSeries(PhysicalPlan):
    start: int
    stop: int
    step: int
    out_schema: Schema
    values: Optional[list] = None  # month-stepped temporal series

    def schema(self) -> Schema:
        return self.out_schema

    def _label(self):
        return f"GenerateSeries: {self.start}..{self.stop} step {self.step}"
