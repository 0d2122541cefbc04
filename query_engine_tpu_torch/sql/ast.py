"""SQL abstract syntax tree.

Parity surface: reference crates/query-parser/src/ast.rs:4-408 — Statement
(Select/WithSelect/CreateIndex/DropIndex/CreateTable/Insert/Update/Delete),
SelectStatement (distinct_on, joins, group/having/order/limit/offset/union),
Expr (qualified columns, binary/unary ops, aggregates, Cast, subqueries,
window functions with frames, scalar functions), JoinType, WindowSpec/
WindowFrame, SetOperation, ON CONFLICT upsert clauses, RETURNING.

Superset extensions beyond the reference grammar (standard SQL that real PG
clients emit): LIKE/ILIKE, BETWEEN, IS [NOT] NULL, IN (value list), CASE,
INTERSECT/EXCEPT, COUNT(DISTINCT x).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from query_engine_tpu_torch.core.types import DataType


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------
class Expr:
    pass


@dataclass(frozen=True)
class Column(Expr):
    name: str


@dataclass(frozen=True)
class QualifiedColumn(Expr):
    table: str
    column: str


@dataclass(frozen=True)
class Wildcard(Expr):
    """`*` inside COUNT(*)."""


@dataclass(frozen=True)
class NumberLit(Expr):
    value: str  # kept as text; typed at planning (int vs float)
    # a bound parameter's value: arithmetic takes it as the DOUBLE it was
    # sent as (PostgreSQL's float8), where a literal written in the text is
    # an exact numeric
    bound: bool = field(default=False, compare=False)


@dataclass(frozen=True)
class StringLit(Expr):
    value: str


@dataclass(frozen=True)
class BoolLit(Expr):
    value: bool


@dataclass(frozen=True)
class NullLit(Expr):
    pass


@dataclass(frozen=True)
class Param(Expr):
    """Extended-protocol parameter $n (reference extended.rs:141-230)."""

    index: int


class BinaryOperator(enum.Enum):
    PLUS = "+"
    MINUS = "-"
    MULTIPLY = "*"
    DIVIDE = "/"
    MODULO = "%"
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
    CONCAT_OP = "||"
    # POSIX regex operators (PG: unanchored search; * = case-insensitive)
    REGEX_MATCH = "~"
    REGEX_IMATCH = "~*"
    NOT_REGEX_MATCH = "!~"
    NOT_REGEX_IMATCH = "!~*"
    # SQL standard regex (anchored, %/_ wildcards + regex metachars)
    SIMILAR_TO = "SIMILAR TO"
    NOT_SIMILAR_TO = "NOT SIMILAR TO"
    # JSON extraction (PG): field/element as json or text, path variants
    JSON_GET = "->"
    JSON_GET_TEXT = "->>"
    JSON_PATH = "#>"
    JSON_PATH_TEXT = "#>>"


class UnaryOperator(enum.Enum):
    NOT = "NOT"
    MINUS = "-"


@dataclass(frozen=True)
class BinaryOp(Expr):
    left: Expr
    op: BinaryOperator
    right: Expr


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: UnaryOperator
    expr: Expr


class AggregateFunction(enum.Enum):
    COUNT = "COUNT"
    SUM = "SUM"
    AVG = "AVG"
    MIN = "MIN"
    MAX = "MAX"
    # statistical family (PG: VARIANCE = VAR_SAMP, STDDEV = STDDEV_SAMP)
    VARIANCE = "VARIANCE"
    VAR_POP = "VAR_POP"
    VAR_SAMP = "VAR_SAMP"
    STDDEV = "STDDEV"
    STDDEV_POP = "STDDEV_POP"
    STDDEV_SAMP = "STDDEV_SAMP"
    # ordered-set family (PG WITHIN GROUP syntax; MEDIAN = PERCENTILE_CONT 0.5)
    MEDIAN = "MEDIAN"
    PERCENTILE_CONT = "PERCENTILE_CONT"
    PERCENTILE_DISC = "PERCENTILE_DISC"
    MODE = "MODE"
    # two-argument statistics family: f(Y, X) over rows where BOTH are
    # non-null (PG binary aggregates)
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
    STRING_AGG = "STRING_AGG"
    ARRAY_AGG = "ARRAY_AGG"
    # boolean aggregates (EVERY is the SQL-standard alias of BOOL_AND)
    BOOL_AND = "BOOL_AND"
    BOOL_OR = "BOOL_OR"
    EVERY = "EVERY"


@dataclass(frozen=True)
class Aggregate(Expr):
    func: AggregateFunction
    expr: Expr  # Wildcard() for COUNT(*)
    distinct: bool = False
    # ordered-set aggregates: (fraction, order_desc) from
    # PERCENTILE_CONT(f) WITHIN GROUP (ORDER BY expr [ASC|DESC])
    param: object = None
    # second argument of binary aggregates: COVAR_POP(y, x) etc.
    expr2: object = None
    # in-call ORDER BY of the order-sensitive aggregates:
    # ARRAY_AGG(x ORDER BY k) / STRING_AGG(x, d ORDER BY k) — tuple of
    # OrderByExpr (PG: other aggregates ignore element order)
    agg_order_by: tuple = ()
    # ARRAY_AGG(x) FILTER (WHERE p): kept as a predicate instead of the
    # CASE desugar used everywhere else, because ARRAY_AGG KEEPS NULL
    # inputs — masking would surface excluded rows as NULL elements
    filter: object = None


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    data_type: DataType


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    query: "SelectStatement"


@dataclass(frozen=True)
class InSubquery(Expr):
    expr: Expr
    query: "SelectStatement"
    negated: bool = False


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: Tuple[Expr, ...]
    negated: bool = False


@dataclass(frozen=True)
class QuantifiedComparison(Expr):
    """expr op ANY|SOME|ALL (subquery) — PG quantified comparison."""

    expr: Expr
    op: BinaryOperator  # EQ/NEQ/LT/LTE/GT/GTE
    is_any: bool  # True for ANY/SOME, False for ALL
    query: "SelectStatement"


@dataclass(frozen=True)
class Exists(Expr):
    query: "SelectStatement"
    negated: bool = False


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass(frozen=True)
class Case(Expr):
    operand: Optional[Expr]
    branches: Tuple[Tuple[Expr, Expr], ...]  # (when, then)
    else_expr: Optional[Expr]


class WindowFunctionType(enum.Enum):
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


class WindowFrameMode(enum.Enum):
    ROWS = "ROWS"
    RANGE = "RANGE"


@dataclass(frozen=True)
class WindowFrameBound:
    kind: str  # "CURRENT" | "PRECEDING" | "FOLLOWING"
    offset: Optional[int] = None  # None = UNBOUNDED for PRECEDING/FOLLOWING


@dataclass(frozen=True)
class WindowFrame:
    mode: WindowFrameMode
    start: WindowFrameBound
    end: Optional[WindowFrameBound] = None


@dataclass(frozen=True)
class WindowSpec:
    partition_by: Tuple[Expr, ...] = ()
    order_by: Tuple["OrderByExpr", ...] = ()
    frame: Optional[WindowFrame] = None
    # `OVER name` reference into the WINDOW clause; the parser patches the
    # real spec in after the (later) WINDOW clause is read
    ref: Optional[str] = None


@dataclass(frozen=True)
class GroupingCall(Expr):
    """GROUPING(key...): 0/1 bitmask of which keys are aggregated away in
    the current grouping set (disambiguates rollup NULLs from data NULLs)."""

    args: Tuple[Expr, ...]


@dataclass(frozen=True)
class IntervalLit(Expr):
    """INTERVAL '...' literal, parsed into PG's (months, days, micros)
    triple at parse time."""

    months: int
    days: int
    micros: int


@dataclass(frozen=True)
class WindowAggregate(Expr):
    """Aggregate used as a window function: SUM(x) OVER (...) etc.
    (beyond the reference, whose WindowFunctionType has ranking/offset
    functions only — ast.rs:236-245)."""

    func: AggregateFunction
    arg: Optional[Expr]  # None for COUNT(*)
    distinct: bool
    over: WindowSpec


@dataclass(frozen=True)
class WindowFunction(Expr):
    func: WindowFunctionType
    args: Tuple[Expr, ...]
    over: WindowSpec


class ScalarFunction(enum.Enum):
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
    # math batch (PI and MOD desugar at planning: a literal and `%`)
    EXP = "EXP"
    LN = "LN"
    LOG = "LOG"
    LOG10 = "LOG10"
    SIGN = "SIGN"
    MOD = "MOD"
    PI = "PI"
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
    # string batch
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
    # regex batch (pattern must be a literal; compiled per dictionary value)
    REGEXP_REPLACE = "REGEXP_REPLACE"
    REGEXP_LIKE = "REGEXP_LIKE"
    REGEXP_SUBSTR = "REGEXP_SUBSTR"
    REGEXP_COUNT = "REGEXP_COUNT"
    # array batch (LIST values are terminal host objects)
    STRING_TO_ARRAY = "STRING_TO_ARRAY"
    ARRAY_TO_STRING = "ARRAY_TO_STRING"
    ARRAY_LENGTH = "ARRAY_LENGTH"
    # json batch (path elements must be literals; function forms of #>/#>>)
    JSON_EXTRACT_PATH = "JSON_EXTRACT_PATH"
    JSON_EXTRACT_PATH_TEXT = "JSON_EXTRACT_PATH_TEXT"
    JSON_ARRAY_LENGTH = "JSON_ARRAY_LENGTH"
    JSON_TYPEOF = "JSON_TYPEOF"


@dataclass(frozen=True)
class ScalarFunctionCall(Expr):
    func: ScalarFunction
    args: Tuple[Expr, ...]


@dataclass(frozen=True)
class UdfCall(Expr):
    """User-defined function call resolved at plan time via UdfRegistry."""

    name: str
    args: Tuple[Expr, ...]


# ---------------------------------------------------------------------------
# Select machinery
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class OrderByExpr:
    expr: Expr
    asc: bool = True
    nulls_first: Optional[bool] = None  # default: NULLS LAST for ASC, FIRST for DESC


class SelectItem:
    pass


@dataclass(frozen=True)
class WildcardItem(SelectItem):
    pass


@dataclass(frozen=True)
class QualifiedWildcard(SelectItem):
    table: str


@dataclass(frozen=True)
class ExprItem(SelectItem):
    expr: Expr
    alias: Optional[str] = None


class JoinType(enum.Enum):
    INNER = "INNER"
    LEFT = "LEFT"
    RIGHT = "RIGHT"
    FULL = "FULL"
    CROSS = "CROSS"


class TableReference:
    pass


@dataclass(frozen=True)
class TableName(TableReference):
    name: str
    alias: Optional[str] = None


@dataclass(frozen=True)
class SubqueryRef(TableReference):
    query: "SelectStatement"
    alias: str
    columns: tuple = ()  # AS alias (c1, ...): the output columns renamed


@dataclass(frozen=True)
class TableFnRef(TableReference):
    """Table function in FROM: GENERATE_SERIES(start, stop[, step])
    [AS alias[(col)]] — produces a single int64 column."""
    fn: str
    args: tuple  # of Expr
    alias: str = ""
    columns: tuple = ()


@dataclass(frozen=True)
class UnnestRef(TableReference):
    """UNNEST(list_expr) [AS alias[(col)]] — lateral element explosion of
    a LIST value (one output row per element, in order; NULL/empty lists
    contribute no rows). Joins the preceding FROM items implicitly
    laterally (the expr may reference their columns)."""
    expr: Expr
    alias: str = "unnest"
    column: str = ""


@dataclass(frozen=True)
class ValuesRef(TableReference):
    """(VALUES (...), (...)) AS alias(col, ...) — a literal inline table
    (also the body of a standalone VALUES statement, PG column1.. names)."""
    rows: tuple  # tuple of tuples of Expr
    alias: str = "values"
    columns: tuple = ()  # () -> column1, column2, ...


@dataclass(frozen=True)
class Join:
    join_type: JoinType
    right: TableReference
    on: Optional[Expr] = None
    # JOIN ... USING (c1, c2): equality on the named columns, output keeps
    # ONE merged column per name (PG). NATURAL JOIN = USING(all common).
    using: tuple = ()
    natural: bool = False


class SetOperation(enum.Enum):
    UNION = "UNION"
    UNION_ALL = "UNION ALL"
    INTERSECT = "INTERSECT"
    EXCEPT = "EXCEPT"


@dataclass(frozen=True)
class UnionClause:
    set_op: SetOperation
    select: "SelectStatement"


@dataclass
class SelectStatement:
    projection: List[SelectItem] = field(default_factory=list)
    from_: Optional[TableReference] = None
    joins: List[Join] = field(default_factory=list)
    selection: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderByExpr] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    distinct_on: Optional[List[Expr]] = None  # DISTINCT ON (...) — PG extension
    union_clause: Optional[UnionClause] = None
    # GROUP BY ROLLUP/CUBE/GROUPING SETS: index lists into group_by
    grouping_sets: Optional[List[List[int]]] = None


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------
class Statement:
    pass


@dataclass
class Select(Statement):
    select: SelectStatement


@dataclass(frozen=True)
class CteDefinition:
    name: str
    columns: Optional[Tuple[str, ...]]
    query: SelectStatement


@dataclass
class WithSelect(Statement):
    recursive: bool
    ctes: List[CteDefinition]
    select: SelectStatement


class IndexType(enum.Enum):
    BTREE = "BTREE"
    HASH = "HASH"


@dataclass
class CreateIndex(Statement):
    name: str
    table: str
    columns: List[str]
    unique: bool = False
    index_type: IndexType = IndexType.BTREE


@dataclass
class DropIndex(Statement):
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class ColumnDef:
    name: str
    data_type: DataType
    nullable: bool = True
    serial: bool = False  # SERIAL/BIGSERIAL: auto-increment on INSERT


@dataclass
class CreateTable(Statement):
    name: str
    columns: List[ColumnDef]
    if_not_exists: bool = False


@dataclass
class CreateTableAs(Statement):
    name: str
    query: "Statement"  # Select or WithSelect
    if_not_exists: bool = False


@dataclass
class CreateView(Statement):
    name: str
    query: "Statement"  # Select or WithSelect
    columns: Tuple[str, ...] = ()
    or_replace: bool = False


@dataclass
class DropView(Statement):
    name: str
    if_exists: bool = False


@dataclass
class DropTable(Statement):
    name: str
    if_exists: bool = False


@dataclass
class Truncate(Statement):
    name: str


@dataclass
class Transaction(Statement):
    """Transaction control: BEGIN / COMMIT / ROLLBACK [TO SAVEPOINT s] /
    SAVEPOINT s / RELEASE [SAVEPOINT] s.

    The reference accepts these over pgwire but treats them as no-ops
    (backend.rs:807-832); here they carry real snapshot semantics
    (engine/session.py)."""
    kind: str   # begin | commit | rollback | rollback_to | savepoint | release
    name: str = ""


@dataclass
class AlterTable(Statement):
    """ALTER TABLE t ADD [COLUMN] c TYPE | DROP [COLUMN] c |
    RENAME [COLUMN] a TO b | RENAME TO t2."""
    table: str
    action: str  # add | drop | rename_column | rename_table
    column: Optional[ColumnDef] = None  # for add
    name: str = ""        # drop/rename source column, or new table name
    new_name: str = ""    # rename_column target


@dataclass(frozen=True)
class Assignment:
    column: str
    value: Expr


class ConflictAction:
    pass


@dataclass(frozen=True)
class DoNothing(ConflictAction):
    pass


@dataclass(frozen=True)
class DoUpdate(ConflictAction):
    assignments: Tuple[Assignment, ...]


@dataclass(frozen=True)
class OnConflictClause:
    columns: Tuple[str, ...]
    action: ConflictAction


@dataclass
class Insert(Statement):
    table: str
    columns: Optional[List[str]]
    values: List[List[Expr]]
    on_conflict: Optional[OnConflictClause] = None
    returning: Optional[List[SelectItem]] = None
    # INSERT INTO t [(cols)] SELECT ... — values is empty then
    query: Optional["Statement"] = None


@dataclass
class Update(Statement):
    table: str
    assignments: List[Assignment]
    selection: Optional[Expr] = None
    returning: Optional[List[SelectItem]] = None
    # UPDATE t SET ... FROM u [WHERE ...] — PG multi-table update
    from_table: Optional[TableReference] = None


@dataclass
class Delete(Statement):
    table: str
    selection: Optional[Expr] = None
    returning: Optional[List[SelectItem]] = None
    # DELETE FROM t USING u [WHERE ...] — PG multi-table delete
    using: Optional[TableReference] = None
