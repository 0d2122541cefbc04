"""Logical plan + typed logical expressions.

Parity surface: reference crates/query-planner/src/logical_plan.rs:8-161 —
LogicalPlan (TableScan, Projection, Filter, Join, Aggregate, Sort, Limit,
EmptyRelation, SubqueryScan, Window, IndexScan), LogicalExpr (column-by-index,
literals, binary/unary, aggregate, Cast, Alias, subqueries, window fns,
scalar fns), ScalarValue.

Superset nodes: Distinct (DISTINCT / DISTINCT ON), SetOp (UNION/INTERSECT/
EXCEPT), Values (INSERT planning) — claimed by the reference's grammar but
absent from its plan enum.

Typing follows the reference *executor's* actual behavior, which is the
parity oracle (operators.rs:745-848): COUNT->Int64, SUM(int)->Int64,
SUM(float)->Float64, AVG->Float64, MIN/MAX->input type; arithmetic coerces
int+float->Float64, int+int->Int64 (operators.rs:616-675).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.sql import ast


# ---------------------------------------------------------------------------
# Scalar values
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ScalarValue:
    """A typed literal (reference logical_plan.rs:146-161)."""

    dtype: DataType
    value: object  # python int/float/str/bool/None

    @staticmethod
    def int64(v: int) -> "ScalarValue":
        return ScalarValue(DataType.int64(), int(v))

    @staticmethod
    def float64(v: float) -> "ScalarValue":
        return ScalarValue(DataType.float64(), float(v))

    @staticmethod
    def utf8(v: str) -> "ScalarValue":
        return ScalarValue(DataType.utf8(), v)

    @staticmethod
    def boolean(v: bool) -> "ScalarValue":
        return ScalarValue(DataType.boolean(), bool(v))

    @staticmethod
    def null() -> "ScalarValue":
        return ScalarValue(DataType.null(), None)

    @property
    def is_null(self) -> bool:
        return self.value is None


# ---------------------------------------------------------------------------
# Logical expressions (typed, columns resolved by index)
# ---------------------------------------------------------------------------
class LogicalExpr:
    """Base class; every expr knows its output type and nullability."""

    dtype: DataType
    nullable: bool = True

    def name(self) -> str:
        raise NotImplementedError


@dataclass
class ColumnRef(LogicalExpr):
    index: int
    col_name: str
    dtype: DataType
    nullable: bool = True

    def name(self) -> str:
        return self.col_name


@dataclass
class Literal(LogicalExpr):
    value: ScalarValue

    def __post_init__(self):
        self.dtype = self.value.dtype
        self.nullable = self.value.is_null

    def name(self) -> str:
        v = self.value.value
        return "NULL" if v is None else str(v)


@dataclass
class IntervalLiteral(LogicalExpr):
    """Interval literal carried statically (months, days, micros) — PG's
    interval triple. Only valid as an operand of temporal +/-; it never
    materializes a device plane."""

    months: int
    days: int
    micros: int

    def __post_init__(self):
        self.dtype = DataType(TypeKind.INTERVAL)
        self.nullable = False

    def name(self) -> str:
        return f"INTERVAL '{self.months}mo {self.days}d {self.micros}us'"


class BinOp(enum.Enum):
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"
    EQ = "="
    NEQ = "!="
    LT = "<"
    LTE = "<="
    GT = ">"
    GTE = ">="
    AND = "AND"
    OR = "OR"
    TS_MATCH = "@@"
    LIKE = "LIKE"
    ILIKE = "ILIKE"
    NOT_LIKE = "NOT LIKE"
    NOT_ILIKE = "NOT ILIKE"
    CONCAT = "||"
    REGEX_MATCH = "~"
    REGEX_IMATCH = "~*"
    NOT_REGEX_MATCH = "!~"
    NOT_REGEX_IMATCH = "!~*"
    SIMILAR_TO = "SIMILAR TO"
    NOT_SIMILAR_TO = "NOT SIMILAR TO"
    # JSON extraction (PG semantics; evaluated per dictionary value)
    JSON_GET = "->"
    JSON_GET_TEXT = "->>"
    JSON_PATH = "#>"
    JSON_PATH_TEXT = "#>>"


_CMP_OPS = {BinOp.EQ, BinOp.NEQ, BinOp.LT, BinOp.LTE, BinOp.GT, BinOp.GTE}
_BOOL_OPS = {BinOp.AND, BinOp.OR}
_REGEX_OPS = {
    BinOp.REGEX_MATCH, BinOp.REGEX_IMATCH, BinOp.NOT_REGEX_MATCH,
    BinOp.NOT_REGEX_IMATCH, BinOp.SIMILAR_TO, BinOp.NOT_SIMILAR_TO,
}
_PRED_OPS = _CMP_OPS | _BOOL_OPS | {
    BinOp.TS_MATCH, BinOp.LIKE, BinOp.ILIKE, BinOp.NOT_LIKE, BinOp.NOT_ILIKE
} | _REGEX_OPS
_JSON_OPS = {BinOp.JSON_GET, BinOp.JSON_GET_TEXT, BinOp.JSON_PATH,
             BinOp.JSON_PATH_TEXT}


def coerce_numeric(l: DataType, r: DataType) -> DataType:
    """Numeric coercion parity: any float -> Float64 else Int64
    (reference operators.rs:616-675, planner.rs:831-848)."""
    if l.is_float or r.is_float:
        return DataType.float64()
    return DataType.int64()


def _dec_scale(t: DataType) -> int:
    return t.params[1] if t.params else 0


def coerce_arith(op: "BinOp", l: DataType, r: DataType) -> DataType:
    if l.kind is TypeKind.INTERVAL or r.kind is TypeKind.INTERVAL:
        # temporal +/- interval keeps the temporal type (interval + temporal
        # commutes); handled before generic coercion
        other = r if l.kind is TypeKind.INTERVAL else l
        return other
    if (
        op is BinOp.SUB and l.kind is TypeKind.DATE32
        and r.kind is TypeKind.DATE32
    ):
        return DataType.int64()  # date - date -> days (PG integer)

    """Arithmetic result type. Decimals follow PG-style scale rules:
    add/sub/mod keep max scale, mul adds scales, div (and any float
    operand) goes to float64."""
    l_dec = l.kind is TypeKind.DECIMAL128
    r_dec = r.kind is TypeKind.DECIMAL128
    if l_dec or r_dec:
        if op is BinOp.DIV or l.is_float or r.is_float:
            return DataType.float64()
        s1 = _dec_scale(l) if l_dec else 0
        s2 = _dec_scale(r) if r_dec else 0
        scale = s1 + s2 if op is BinOp.MUL else max(s1, s2)
        return DataType.decimal128(38, scale)
    return coerce_numeric(l, r)


@dataclass
class BinaryExpr(LogicalExpr):
    left: LogicalExpr
    op: BinOp
    right: LogicalExpr

    def __post_init__(self):
        if self.op in _PRED_OPS:
            self.dtype = DataType.boolean()
        elif self.op in _JSON_OPS:
            # -> / #> yield json, ->> / #>> text; both are string-backed
            # (dictionary-encoded) device-side
            self.dtype = DataType.utf8()
        elif self.op is BinOp.CONCAT:
            self.dtype = DataType.utf8()
        else:
            lt, rt = self.left.dtype, self.right.dtype
            if lt.is_dictionary or rt.is_dictionary:
                self.dtype = DataType.utf8()
            else:
                self.dtype = coerce_arith(self.op, lt, rt)
        self.nullable = self.left.nullable or self.right.nullable

    def name(self) -> str:
        return f"{self.left.name()} {self.op.value} {self.right.name()}"


class UnOp(enum.Enum):
    NOT = "NOT"
    NEG = "-"


@dataclass
class UnaryExpr(LogicalExpr):
    op: UnOp
    expr: LogicalExpr

    def __post_init__(self):
        self.dtype = (
            DataType.boolean() if self.op is UnOp.NOT else self.expr.dtype
        )
        self.nullable = self.expr.nullable

    def name(self) -> str:
        return f"{self.op.value} {self.expr.name()}"


class AggFunc(enum.Enum):
    COUNT = "COUNT"
    SUM = "SUM"
    AVG = "AVG"
    MIN = "MIN"
    MAX = "MAX"
    # statistical family: lowered into (SUM, SUM(x^2), COUNT) + a formula
    # projection (plan/lowering.py), so every execution path — eager,
    # compiled, mesh partial/final, chunked — runs only base aggregates
    VAR_POP = "VAR_POP"
    VAR_SAMP = "VAR_SAMP"
    STDDEV_POP = "STDDEV_POP"
    STDDEV_SAMP = "STDDEV_SAMP"
    # ordered-set family: sort-based per-group quantiles; param carries
    # (fraction, order_desc). Not decomposable — the eager engine computes
    # them (compiled/mesh demote gracefully), distributed plans gather.
    PERCENTILE_CONT = "PERCENTILE_CONT"
    PERCENTILE_DISC = "PERCENTILE_DISC"
    MODE = "MODE"
    # two-argument statistics f(Y, X): like VARIANCE, lowered into
    # pair-masked SUM/COUNT components + a formula projection, so they
    # distribute and chunk through the ordinary partial/final machinery
    COVAR_POP = "COVAR_POP"
    COVAR_SAMP = "COVAR_SAMP"
    CORR = "CORR"
    REGR_SLOPE = "REGR_SLOPE"
    REGR_INTERCEPT = "REGR_INTERCEPT"
    REGR_R2 = "REGR_R2"
    REGR_AVGX = "REGR_AVGX"
    REGR_AVGY = "REGR_AVGY"
    REGR_COUNT = "REGR_COUNT"
    REGR_SXX = "REGR_SXX"
    REGR_SYY = "REGR_SYY"
    REGR_SXY = "REGR_SXY"
    # STRING_AGG(expr, delim): per-group ordered concatenation. Host
    # finalization over dictionary codes (eager engine only; compiled/mesh
    # demote, distributed gathers via single_agg). param = (delim, False).
    STRING_AGG = "STRING_AGG"
    # ARRAY_AGG(expr): per-group list in input order (PG: NULL inputs are
    # KEPT). Host finalization; result column is a dictionary of Python
    # lists with dtype List<elem>.
    ARRAY_AGG = "ARRAY_AGG"
    # boolean aggregates: lowered into MIN/MAX over a 0/1 mask + an = 1
    # comparison, so they distribute/chunk like everything else
    BOOL_AND = "BOOL_AND"
    BOOL_OR = "BOOL_OR"


VARIANCE_FNS = {
    AggFunc.VAR_POP, AggFunc.VAR_SAMP,
    AggFunc.STDDEV_POP, AggFunc.STDDEV_SAMP,
}

PERCENTILE_FNS = {AggFunc.PERCENTILE_CONT, AggFunc.PERCENTILE_DISC}

# ordered-set aggregates (WITHIN GROUP): sort-based, not decomposable —
# the eager engine computes them; compiled/mesh demote, distributed gathers
ORDERED_SET_FNS = PERCENTILE_FNS | {AggFunc.MODE}

COVAR_FNS = {
    AggFunc.COVAR_POP, AggFunc.COVAR_SAMP, AggFunc.CORR,
    AggFunc.REGR_SLOPE, AggFunc.REGR_INTERCEPT, AggFunc.REGR_R2,
    AggFunc.REGR_AVGX, AggFunc.REGR_AVGY, AggFunc.REGR_COUNT,
    AggFunc.REGR_SXX, AggFunc.REGR_SYY, AggFunc.REGR_SXY,
}

BOOL_FNS = {AggFunc.BOOL_AND, AggFunc.BOOL_OR}


@dataclass
class AggregateExpr(LogicalExpr):
    func: AggFunc
    expr: Optional[LogicalExpr]  # None for COUNT(*)
    distinct: bool = False
    # PERCENTILE_CONT/DISC: (fraction, order_desc)
    param: Optional[tuple] = None
    # second argument of binary aggregates: COVAR_POP(y, x) etc.
    expr2: Optional[LogicalExpr] = None
    # in-call ORDER BY of the order-sensitive aggregates — tuple of
    # (key_expr, asc, nulls_first); host finalization sorts each group
    order_by: tuple = ()
    # ARRAY_AGG row-exclusion predicate (FILTER (WHERE p) — other
    # aggregates desugar FILTER into CASE masking at parse time)
    filter: Optional[LogicalExpr] = None

    def __post_init__(self):
        f = self.func
        if f is AggFunc.COUNT or f is AggFunc.REGR_COUNT:
            self.dtype = DataType.int64()
            self.nullable = False
        elif (f is AggFunc.AVG or f in VARIANCE_FNS or f in COVAR_FNS
              or f is AggFunc.PERCENTILE_CONT):
            self.dtype = DataType.float64()
        elif f in BOOL_FNS:
            self.dtype = DataType.boolean()
        elif f is AggFunc.PERCENTILE_DISC or f is AggFunc.MODE:
            self.dtype = self.expr.dtype
        elif f is AggFunc.STRING_AGG:
            self.dtype = DataType.utf8()
        elif f is AggFunc.ARRAY_AGG:
            self.dtype = DataType.list_(self.expr.dtype)
        elif f is AggFunc.SUM:
            t = self.expr.dtype
            if t.kind is TypeKind.DECIMAL128:
                self.dtype = t  # scaled-int sum keeps the scale
            else:
                self.dtype = DataType.float64() if t.is_float else DataType.int64()
        else:  # MIN/MAX keep input type
            self.dtype = self.expr.dtype
        if f is not AggFunc.COUNT and f is not AggFunc.REGR_COUNT:
            self.nullable = True

    def name(self) -> str:
        inner = "*" if self.expr is None else self.expr.name()
        d = "DISTINCT " if self.distinct else ""
        if self.func in ORDERED_SET_FNS:
            frac, desc = self.param
            o = " DESC" if desc else ""
            head = "" if self.func is AggFunc.MODE else str(frac)
            return (f"{self.func.value}({head}) WITHIN GROUP "
                    f"(ORDER BY {inner}{o})")
        if self.func in COVAR_FNS:
            return f"{self.func.value}({inner}, {self.expr2.name()})"
        # in-call ORDER BY and FILTER must appear in the name: the
        # planner's aggregate dedup keys on name(), and two aggregates
        # differing only in ordering/predicate must not alias
        ob = ""
        if self.order_by:
            keys = ", ".join(
                k.name() + ("" if asc else " DESC")
                + ("" if nf == (not asc) else
                   (" NULLS FIRST" if nf else " NULLS LAST"))
                for k, asc, nf in self.order_by
            )
            ob = f" ORDER BY {keys}"
        flt = f" FILTER ({self.filter.name()})" if self.filter is not None else ""
        if self.func is AggFunc.STRING_AGG:
            return f"STRING_AGG({d}{inner}, {self.param[0]!r}{ob}){flt}"
        return f"{self.func.value}({d}{inner}{ob}){flt}"


@dataclass
class CastExpr(LogicalExpr):
    expr: LogicalExpr
    target: DataType

    def __post_init__(self):
        self.dtype = self.target
        self.nullable = self.expr.nullable

    def name(self) -> str:
        return f"CAST({self.expr.name()} AS {self.target})"


@dataclass
class AliasExpr(LogicalExpr):
    expr: LogicalExpr
    alias: str

    def __post_init__(self):
        self.dtype = self.expr.dtype
        self.nullable = self.expr.nullable

    def name(self) -> str:
        return self.alias


class ScalarFn(enum.Enum):
    UPPER = "UPPER"
    LOWER = "LOWER"
    LENGTH = "LENGTH"
    CONCAT = "CONCAT"
    SUBSTRING = "SUBSTRING"
    TRIM = "TRIM"
    REPLACE = "REPLACE"
    ABS = "ABS"
    CEIL = "CEIL"
    FLOOR = "FLOOR"
    ROUND = "ROUND"
    SQRT = "SQRT"
    POWER = "POWER"
    COALESCE = "COALESCE"
    NULLIF = "NULLIF"
    TO_TSVECTOR = "TO_TSVECTOR"
    TO_TSQUERY = "TO_TSQUERY"
    EXTRACT = "EXTRACT"
    DATE_TRUNC = "DATE_TRUNC"
    # math batch (all device-vectorized, engine/expr_eval.py)
    EXP = "EXP"
    LN = "LN"
    LOG = "LOG"        # LOG(x) = log10; LOG(b, x) = log base b (PG)
    LOG10 = "LOG10"
    SIGN = "SIGN"
    SIN = "SIN"
    COS = "COS"
    TAN = "TAN"
    ASIN = "ASIN"
    ACOS = "ACOS"
    ATAN = "ATAN"
    ATAN2 = "ATAN2"
    DEGREES = "DEGREES"
    RADIANS = "RADIANS"
    TRUNC = "TRUNC"
    GREATEST = "GREATEST"
    LEAST = "LEAST"
    # string batch (host per-dictionary-value, like UPPER/SUBSTRING)
    LEFT = "LEFT"
    RIGHT = "RIGHT"
    LPAD = "LPAD"
    RPAD = "RPAD"
    REVERSE = "REVERSE"
    INITCAP = "INITCAP"
    SPLIT_PART = "SPLIT_PART"
    REPEAT = "REPEAT"
    LTRIM = "LTRIM"
    RTRIM = "RTRIM"
    STRPOS = "STRPOS"
    STARTS_WITH = "STARTS_WITH"
    # regex batch (host per-dictionary-value; pattern must be a literal)
    REGEXP_REPLACE = "REGEXP_REPLACE"
    REGEXP_LIKE = "REGEXP_LIKE"
    REGEXP_SUBSTR = "REGEXP_SUBSTR"
    REGEXP_COUNT = "REGEXP_COUNT"
    # array batch (LIST values; host per-dictionary-value)
    STRING_TO_ARRAY = "STRING_TO_ARRAY"
    ARRAY_TO_STRING = "ARRAY_TO_STRING"
    ARRAY_LENGTH = "ARRAY_LENGTH"
    # json batch (function forms of #> / #>>; path elements are literals,
    # so extraction tables build per dictionary value at trace time)
    JSON_EXTRACT_PATH = "JSON_EXTRACT_PATH"
    JSON_EXTRACT_PATH_TEXT = "JSON_EXTRACT_PATH_TEXT"
    JSON_ARRAY_LENGTH = "JSON_ARRAY_LENGTH"
    JSON_TYPEOF = "JSON_TYPEOF"


_STRING_FNS = {ScalarFn.UPPER, ScalarFn.LOWER, ScalarFn.CONCAT,
               ScalarFn.SUBSTRING, ScalarFn.TRIM, ScalarFn.REPLACE,
               ScalarFn.LEFT, ScalarFn.RIGHT, ScalarFn.LPAD, ScalarFn.RPAD,
               ScalarFn.REVERSE, ScalarFn.INITCAP, ScalarFn.SPLIT_PART,
               ScalarFn.REPEAT, ScalarFn.LTRIM, ScalarFn.RTRIM,
               ScalarFn.REGEXP_REPLACE, ScalarFn.REGEXP_SUBSTR}

_MATH_F64_FNS = {ScalarFn.EXP, ScalarFn.LN, ScalarFn.LOG, ScalarFn.LOG10,
                 ScalarFn.SIGN, ScalarFn.SIN, ScalarFn.COS, ScalarFn.TAN,
                 ScalarFn.ASIN, ScalarFn.ACOS, ScalarFn.ATAN,
                 ScalarFn.ATAN2, ScalarFn.DEGREES, ScalarFn.RADIANS,
                 ScalarFn.TRUNC}


@dataclass
class ScalarFnExpr(LogicalExpr):
    func: ScalarFn
    args: List[LogicalExpr]

    def __post_init__(self):
        f = self.func
        if f in _STRING_FNS:
            self.dtype = DataType.utf8()
        elif f is ScalarFn.STRING_TO_ARRAY:
            self.dtype = DataType.list_(DataType.utf8())
        elif f is ScalarFn.ARRAY_TO_STRING:
            self.dtype = DataType.utf8()
        elif f in (ScalarFn.LENGTH, ScalarFn.STRPOS, ScalarFn.REGEXP_COUNT,
                   ScalarFn.ARRAY_LENGTH):
            self.dtype = DataType.int64()
        elif f in (ScalarFn.STARTS_WITH, ScalarFn.REGEXP_LIKE):
            self.dtype = DataType.boolean()
        elif f in (ScalarFn.CEIL, ScalarFn.FLOOR, ScalarFn.ROUND,
                   ScalarFn.SQRT, ScalarFn.POWER) or f in _MATH_F64_FNS:
            self.dtype = DataType.float64()
        elif f is ScalarFn.ABS:
            self.dtype = self.args[0].dtype
        elif f in (ScalarFn.GREATEST, ScalarFn.LEAST):
            self.dtype = next(
                (a.dtype for a in self.args
                 if a.dtype.kind is not TypeKind.NULL),
                DataType.null(),
            )
        elif f in (ScalarFn.COALESCE, ScalarFn.NULLIF):
            self.dtype = next(
                (a.dtype for a in self.args if a.dtype.kind is not TypeKind.NULL),
                DataType.null(),
            )
        elif f in (ScalarFn.JSON_EXTRACT_PATH,
                   ScalarFn.JSON_EXTRACT_PATH_TEXT,
                   ScalarFn.JSON_TYPEOF):
            # like -> / ->>: json and text results are both string-backed
            self.dtype = DataType.utf8()
        elif f is ScalarFn.JSON_ARRAY_LENGTH:
            self.dtype = DataType.int64()
        elif f is ScalarFn.EXTRACT:
            field = ""
            if self.args and isinstance(self.args[0], Literal):
                field = str(self.args[0].value.value or "")
            # PG returns numeric; fractional only for second/epoch
            self.dtype = (
                DataType.float64() if field in ("second", "epoch")
                else DataType.int64()
            )
        elif f is ScalarFn.DATE_TRUNC:
            self.dtype = (
                self.args[1].dtype if len(self.args) > 1 else DataType.int64()
            )
        elif f is ScalarFn.TO_TSVECTOR:
            self.dtype = DataType(TypeKind.TSVECTOR)
        elif f is ScalarFn.TO_TSQUERY:
            self.dtype = DataType(TypeKind.TSQUERY)
        else:
            self.dtype = DataType.float64()
        # JSON extraction/inspection introduces NULLs from non-nullable
        # inputs (missing fields, malformed docs, non-array lengths)
        self.nullable = (
            any(a.nullable for a in self.args)
            or f in (ScalarFn.NULLIF, ScalarFn.JSON_EXTRACT_PATH,
                     ScalarFn.JSON_EXTRACT_PATH_TEXT,
                     ScalarFn.JSON_ARRAY_LENGTH, ScalarFn.JSON_TYPEOF)
        )

    def name(self) -> str:
        return f"{self.func.value}({', '.join(a.name() for a in self.args)})"


@dataclass
class UdfExpr(LogicalExpr):
    fn_name: str
    args: List[LogicalExpr]
    dtype: DataType = field(default_factory=DataType.float64)
    nullable: bool = True

    def name(self) -> str:
        return f"{self.fn_name}({', '.join(a.name() for a in self.args)})"


class WindowFn(enum.Enum):
    ROW_NUMBER = "ROW_NUMBER"
    RANK = "RANK"
    DENSE_RANK = "DENSE_RANK"
    NTILE = "NTILE"
    PERCENT_RANK = "PERCENT_RANK"
    CUME_DIST = "CUME_DIST"
    LAG = "LAG"
    LEAD = "LEAD"
    FIRST_VALUE = "FIRST_VALUE"
    LAST_VALUE = "LAST_VALUE"
    NTH_VALUE = "NTH_VALUE"
    # aggregates over window frames (running totals / rolling windows)
    SUM = "SUM"
    COUNT = "COUNT"
    AVG = "AVG"
    MIN = "MIN"
    MAX = "MAX"


WINDOW_AGG_FNS = {
    WindowFn.SUM, WindowFn.COUNT, WindowFn.AVG, WindowFn.MIN, WindowFn.MAX,
}


@dataclass
class SortKey:
    expr: LogicalExpr
    asc: bool = True
    nulls_first: Optional[bool] = None  # None => PG default (LAST if asc)

    def resolved_nulls_first(self) -> bool:
        if self.nulls_first is None:
            return not self.asc
        return self.nulls_first


@dataclass
class WindowExpr(LogicalExpr):
    func: WindowFn
    args: List[LogicalExpr]
    partition_by: List[LogicalExpr] = field(default_factory=list)
    order_by: List[SortKey] = field(default_factory=list)
    frame: Optional[ast.WindowFrame] = None

    def __post_init__(self):
        if self.func in (WindowFn.ROW_NUMBER, WindowFn.RANK,
                         WindowFn.DENSE_RANK, WindowFn.NTILE):
            self.dtype = DataType.int64()
            self.nullable = False
        elif self.func in (WindowFn.PERCENT_RANK, WindowFn.CUME_DIST):
            self.dtype = DataType.float64()
            self.nullable = False
        elif self.func is WindowFn.COUNT:
            self.dtype = DataType.int64()
            self.nullable = False
        elif self.func is WindowFn.AVG:
            self.dtype = DataType.float64()
            self.nullable = True
        elif self.func is WindowFn.SUM:
            t = self.args[0].dtype
            if t.kind is TypeKind.DECIMAL128:
                self.dtype = t
            else:
                self.dtype = (
                    DataType.float64() if t.is_float else DataType.int64()
                )
            self.nullable = True
        else:  # LAG/LEAD/FIRST_VALUE/LAST_VALUE/MIN/MAX track arg type
            self.dtype = self.args[0].dtype if self.args else DataType.int64()
            self.nullable = True

    def name(self) -> str:
        return f"{self.func.value}({', '.join(a.name() for a in self.args)})"


@dataclass
class CaseExpr(LogicalExpr):
    branches: List[Tuple[LogicalExpr, LogicalExpr]]  # (bool cond, value)
    else_expr: Optional[LogicalExpr]

    def __post_init__(self):
        self.dtype = self.branches[0][1].dtype
        self.nullable = True

    def name(self) -> str:
        # must spell out the branches: aggregate dedup keys on name(), so a
        # bare "CASE" would alias AVG(CASE WHEN a ...) with AVG(CASE WHEN
        # b ...) — e.g. two different FILTER clauses collapsing to one
        parts = " ".join(
            f"WHEN {c.name()} THEN {v.name()}" for c, v in self.branches
        )
        tail = f" ELSE {self.else_expr.name()}" if self.else_expr else ""
        return f"CASE {parts}{tail} END"


@dataclass
class InListExpr(LogicalExpr):
    expr: LogicalExpr
    items: List[LogicalExpr]
    negated: bool = False

    def __post_init__(self):
        self.dtype = DataType.boolean()
        self.nullable = self.expr.nullable

    def name(self) -> str:
        # full item list + negation: aggregate dedup keys on name(), so
        # `x IN (...)` hiding the items would alias SUM(CASE WHEN x IN (a)
        # ...) with SUM(CASE WHEN x NOT IN (b) ...)
        neg = " NOT" if self.negated else ""
        items = ", ".join(i.name() for i in self.items)
        return f"{self.expr.name()}{neg} IN ({items})"


@dataclass
class IsNullExpr(LogicalExpr):
    expr: LogicalExpr
    negated: bool = False

    def __post_init__(self):
        self.dtype = DataType.boolean()
        self.nullable = False

    def name(self) -> str:
        neg = " NOT" if self.negated else ""
        return f"{self.expr.name()} IS{neg} NULL"




def _plan_tag(plan) -> str:
    """Deterministic fingerprint of a subquery plan for name() tags.
    Aggregate dedup keys on name(), and the planner plans the same AST
    aggregate twice (collect + post-agg rewrite), creating fresh subplan
    objects each time — so the tag must be STRUCTURAL (identical SQL =>
    identical tag) yet distinguish different subqueries. CRC32 of the
    pretty-printed plan does both; cached on the plan object."""
    t = getattr(plan, "_qe_name_tag", None)
    if t is None:
        import zlib

        t = f"{zlib.crc32(plan.pretty().encode()) & 0xffffffff:08x}"
        try:
            plan._qe_name_tag = t
        except Exception:
            pass
    return t


@dataclass
class ScalarSubqueryExpr(LogicalExpr):
    plan: "LogicalPlan"

    def __post_init__(self):
        self.dtype = self.plan.schema().field(0).data_type
        self.nullable = True

    def name(self) -> str:
        # id-tagged: aggregate dedup keys on name(), and two DIFFERENT
        # subqueries must not alias (display prettiness matters less than
        # correctness; users alias subquery outputs anyway)
        return f"(subquery#{_plan_tag(self.plan)})"


@dataclass
class InSubqueryExpr(LogicalExpr):
    expr: LogicalExpr
    plan: "LogicalPlan"
    negated: bool = False

    def __post_init__(self):
        self.dtype = DataType.boolean()
        self.nullable = self.expr.nullable

    def name(self) -> str:
        neg = " NOT" if self.negated else ""
        return f"{self.expr.name()}{neg} IN (subquery#{_plan_tag(self.plan)})"


@dataclass
class QuantifiedCmpExpr(LogicalExpr):
    """expr op ANY|ALL (subquery). =ANY / <>ALL route to InSubqueryExpr at
    planning (rank membership); the remaining forms reduce to MIN/MAX of
    the subquery column + PG 3-valued logic over (has rows, has non-null,
    has null) — one subplan execution per query, no per-row re-execution."""

    expr: LogicalExpr
    op: BinOp  # EQ/NEQ/LT/LTE/GT/GTE
    is_any: bool
    plan: "LogicalPlan"

    def __post_init__(self):
        self.dtype = DataType.boolean()
        self.nullable = True

    def name(self) -> str:
        q = "ANY" if self.is_any else "ALL"
        return (f"{self.expr.name()} {self.op.value} {q}"
                f"(subquery#{_plan_tag(self.plan)})")


@dataclass
class CorrelatedLookupExpr(LogicalExpr):
    """Decorrelated subquery (the reference leaves correlated subqueries
    unimplemented; operators.rs:34-52 errors on all subquery forms).

    The subplan computes (key columns..., value column?) — one row per
    distinct correlation key — and evaluation joins the OUTER batch's key
    expressions against those keys, vectorized (one rank-match + gather for
    the whole batch instead of a subquery execution per row).

    mode 'value': result is the value column; misses yield NULL, or
    `miss_value` when set (COUNT over an empty correlated set is 0).
    mode 'exists': result is the found mask (EXISTS never yields NULL).
    """

    outer_keys: List[LogicalExpr]  # evaluated against the outer batch
    plan: "LogicalPlan"  # schema: key cols [0..n_keys), then value col
    mode: str = "value"  # value | exists
    negated: bool = False
    miss_value: Optional[ScalarValue] = None

    def __post_init__(self):
        if self.mode == "exists":
            self.dtype = DataType.boolean()
            self.nullable = False
        else:
            f = self.plan.schema().field(len(self.outer_keys))
            self.dtype = f.data_type
            self.nullable = True

    def name(self) -> str:
        neg = "NOT " if self.negated else ""
        return (f"({neg}correlated {self.mode} "
                f"subquery#{_plan_tag(self.plan)})")


@dataclass
class ExistsExpr(LogicalExpr):
    plan: "LogicalPlan"
    negated: bool = False

    def __post_init__(self):
        self.dtype = DataType.boolean()
        self.nullable = False

    def name(self) -> str:
        # id-tagged like the other subquery exprs: aggregate dedup keys on
        # name(), and two different EXISTS subqueries must not alias
        neg = "NOT " if self.negated else ""
        return f"{neg}EXISTS (subquery#{_plan_tag(self.plan)})"


# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------
class LogicalPlan:
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> List["LogicalPlan"]:
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
class TableScan(LogicalPlan):
    table_name: str
    table_schema: Schema  # already alias-prefixed
    projection: Optional[List[int]] = None

    def schema(self) -> Schema:
        if self.projection is None:
            return self.table_schema
        return self.table_schema.project(self.projection)

    def _label(self) -> str:
        proj = "" if self.projection is None else f" projection={self.projection}"
        return f"TableScan: {self.table_name}{proj}"


@dataclass
class Projection(LogicalPlan):
    input: LogicalPlan
    exprs: List[LogicalExpr]

    def schema(self) -> Schema:
        return Schema(
            [Field(e.name(), e.dtype, e.nullable) for e in self.exprs]
        )

    def children(self):
        return [self.input]

    def _label(self) -> str:
        return f"Projection: {', '.join(e.name() for e in self.exprs)}"


@dataclass
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: LogicalExpr

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def _label(self) -> str:
        return f"Filter: {self.predicate.name()}"


class JoinType(enum.Enum):
    INNER = "INNER"
    LEFT = "LEFT"
    RIGHT = "RIGHT"
    FULL = "FULL"
    CROSS = "CROSS"


@dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    join_type: JoinType
    on: Optional[LogicalExpr]  # predicate over merged schema (equi-keys
    # extracted at physical planning)

    def schema(self) -> Schema:
        merged = self.left.schema().merge(self.right.schema())
        if self.join_type in (JoinType.LEFT, JoinType.FULL):
            # right side columns become nullable
            nl = len(self.left.schema())
            fields = list(merged.fields)
            fields = fields[:nl] + [
                Field(f.name, f.data_type, True) for f in fields[nl:]
            ]
            merged = Schema(fields)
        if self.join_type in (JoinType.RIGHT, JoinType.FULL):
            nl = len(self.left.schema())
            fields = list(merged.fields)
            fields = [
                Field(f.name, f.data_type, True) for f in fields[:nl]
            ] + fields[nl:]
            merged = Schema(fields)
        return merged

    def children(self):
        return [self.left, self.right]

    def _label(self) -> str:
        on = f" on {self.on.name()}" if self.on is not None else ""
        return f"Join: {self.join_type.value}{on}"


@dataclass
class Aggregate(LogicalPlan):
    input: LogicalPlan
    group_exprs: List[LogicalExpr]
    agg_exprs: List[AggregateExpr]

    def schema(self) -> Schema:
        fields = [Field(e.name(), e.dtype, e.nullable) for e in self.group_exprs]
        fields += [Field(e.name(), e.dtype, e.nullable) for e in self.agg_exprs]
        return Schema(fields)

    def children(self):
        return [self.input]

    def _label(self) -> str:
        g = ", ".join(e.name() for e in self.group_exprs)
        a = ", ".join(e.name() for e in self.agg_exprs)
        return f"Aggregate: group=[{g}] aggr=[{a}]"


@dataclass
class Sort(LogicalPlan):
    input: LogicalPlan
    keys: List[SortKey]

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def _label(self) -> str:
        ks = ", ".join(
            f"{k.expr.name()} {'ASC' if k.asc else 'DESC'}" for k in self.keys
        )
        return f"Sort: {ks}"


@dataclass
class Limit(LogicalPlan):
    input: LogicalPlan
    skip: int = 0
    fetch: Optional[int] = None

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def _label(self) -> str:
        return f"Limit: skip={self.skip} fetch={self.fetch}"


@dataclass
class EmptyRelation(LogicalPlan):
    rel_schema: Schema
    produce_one_row: bool = False

    def schema(self) -> Schema:
        return self.rel_schema


@dataclass
class SubqueryScan(LogicalPlan):
    input: LogicalPlan
    alias: str
    sub_schema: Schema  # alias-prefixed

    def schema(self) -> Schema:
        return self.sub_schema

    def children(self):
        return [self.input]

    def _label(self) -> str:
        return f"SubqueryScan: {self.alias}"


@dataclass
class Window(LogicalPlan):
    input: LogicalPlan
    window_exprs: List[WindowExpr]
    names: List[str]

    def schema(self) -> Schema:
        fields = list(self.input.schema().fields)
        fields += [
            Field(n, e.dtype, e.nullable)
            for n, e in zip(self.names, self.window_exprs)
        ]
        return Schema(fields)

    def children(self):
        return [self.input]

    def _label(self) -> str:
        return f"Window: {', '.join(self.names)}"


@dataclass
class IndexScan(LogicalPlan):
    table_name: str
    table_schema: Schema
    index_name: str
    index_predicates: List[LogicalExpr]
    residual: Optional[LogicalExpr] = None

    def schema(self) -> Schema:
        return self.table_schema

    def _label(self) -> str:
        return f"IndexScan: {self.table_name} via {self.index_name}"


@dataclass
class Distinct(LogicalPlan):
    input: LogicalPlan
    on: Optional[List[LogicalExpr]] = None  # DISTINCT ON (...) keys

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]


class SetOpKind(enum.Enum):
    UNION = "UNION"
    UNION_ALL = "UNION ALL"
    INTERSECT = "INTERSECT"
    EXCEPT = "EXCEPT"


@dataclass
class SetOp(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    kind: SetOpKind

    def schema(self) -> Schema:
        return self.left.schema()

    def children(self):
        return [self.left, self.right]

    def _label(self) -> str:
        return f"SetOp: {self.kind.value}"


@dataclass
class Values(LogicalPlan):
    rows: List[List[LogicalExpr]]
    rel_schema: Schema

    def schema(self) -> Schema:
        return self.rel_schema


@dataclass
class Unnest(LogicalPlan):
    """Lateral list-element explosion: one output row per element of
    `list_expr` evaluated on each input row (PG UNNEST in FROM; NULL and
    empty lists contribute zero rows)."""
    input: LogicalPlan
    list_expr: LogicalExpr
    rel_schema: Schema

    def schema(self) -> Schema:
        return self.rel_schema

    def children(self):
        return [self.input]

    def _label(self) -> str:
        return f"Unnest: {self.list_expr.name()}"


@dataclass
class GenerateSeries(LogicalPlan):
    """GENERATE_SERIES(start, stop[, step]): arithmetic series over int64,
    DATE32 (days) or TIMESTAMP (micros) — lowers to a device iota, the
    cheapest possible device relation. Month-stepped temporal series (the one
    non-uniform stride) carry precomputed `values` instead."""
    start: int
    stop: int
    step: int
    rel_schema: Schema
    values: Optional[list] = None  # host-computed irregular series

    def schema(self) -> Schema:
        return self.rel_schema

    def _label(self) -> str:
        return (f"GenerateSeries: {self.start}..{self.stop} "
                f"step {self.step}")


def walk_exprs(expr: LogicalExpr, visit) -> None:
    """Pre-order traversal over an expression tree."""
    visit(expr)
    children: Sequence[LogicalExpr] = ()
    if isinstance(expr, BinaryExpr):
        children = (expr.left, expr.right)
    elif isinstance(expr, (UnaryExpr, CastExpr, AliasExpr, IsNullExpr)):
        children = (expr.expr,)
    elif isinstance(expr, AggregateExpr):
        children = tuple(
            c for c in (expr.expr, expr.expr2, expr.filter) if c is not None
        ) + tuple(k for k, _asc, _nf in expr.order_by)
    elif isinstance(expr, (ScalarFnExpr, UdfExpr)):
        children = tuple(expr.args)
    elif isinstance(expr, WindowExpr):
        children = tuple(expr.args) + tuple(expr.partition_by) + tuple(
            k.expr for k in expr.order_by
        )
    elif isinstance(expr, CaseExpr):
        children = tuple(x for b in expr.branches for x in b) + (
            (expr.else_expr,) if expr.else_expr is not None else ()
        )
    elif isinstance(expr, InListExpr):
        children = (expr.expr,) + tuple(expr.items)
    elif isinstance(expr, (InSubqueryExpr, QuantifiedCmpExpr)):
        children = (expr.expr,)
    elif isinstance(expr, CorrelatedLookupExpr):
        children = tuple(expr.outer_keys)
    for c in children:
        walk_exprs(c, visit)


def contains_aggregate(expr: LogicalExpr) -> bool:
    found = []
    walk_exprs(expr, lambda e: found.append(e) if isinstance(e, AggregateExpr) else None)
    return bool(found)


def collect_aggregates(expr: LogicalExpr) -> List[AggregateExpr]:
    found: List[AggregateExpr] = []

    def visit(e):
        if isinstance(e, AggregateExpr):
            found.append(e)

    walk_exprs(expr, visit)
    return found


def contains_window(expr: LogicalExpr) -> bool:
    found = []
    walk_exprs(expr, lambda e: found.append(e) if isinstance(e, WindowExpr) else None)
    return bool(found)
