"""Recursive-descent SQL parser with precedence climbing.

Parity surface: reference crates/query-parser/src/parser.rs:20-1361 —
precedence chain or→and→comparison→additive→multiplicative→unary→primary
(parser.rs grammar), all statements in ast.rs, DISTINCT ON, UNION [ALL],
window frames ROWS/RANGE BETWEEN, DECIMAL(p,s), arrays `INT[]`.

Type-name mapping matches reference parser.rs:157-230 exactly:
INT/INTEGER/BIGINT/INT8 -> Int64; FLOAT/DOUBLE/REAL/FLOAT8 -> Float64; etc.

Superset: IN (value list) — a declared error in the reference
(parser.rs:836-841) — plus LIKE/BETWEEN/IS NULL/CASE/::-casts, which real
PG clients require.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from query_engine_tpu_torch.core.errors import ParseError
from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.sql import ast
from query_engine_tpu_torch.sql.lexer import Token, tokenize

_TWO_ARG_AGG_KWS = {
    "COVAR_POP", "COVAR_SAMP", "CORR", "REGR_SLOPE", "REGR_INTERCEPT",
    "REGR_R2", "REGR_AVGX", "REGR_AVGY", "REGR_COUNT", "REGR_SXX",
    "REGR_SYY", "REGR_SXY", "STRING_AGG",
}
_AGG_KWS = {"COUNT", "SUM", "AVG", "MIN", "MAX", "VARIANCE", "VAR_POP",
            "VAR_SAMP", "STDDEV", "STDDEV_POP", "STDDEV_SAMP",
            "MEDIAN", "BOOL_AND", "BOOL_OR", "EVERY",
            "ARRAY_AGG"} | _TWO_ARG_AGG_KWS
_ORDERED_SET_KWS = {"PERCENTILE_CONT", "PERCENTILE_DISC", "MODE"}
_WINDOW_KWS = {
    "ROW_NUMBER", "RANK", "DENSE_RANK", "NTILE", "LAG", "LEAD",
    "FIRST_VALUE", "LAST_VALUE", "PERCENT_RANK", "CUME_DIST", "NTH_VALUE",
}
# words that may follow a table name but must never be captured as an
# implicit alias (they lex as IDENT, not KEYWORD)
_NON_ALIAS_WORDS = {"NATURAL", "FETCH", "LATERAL", "TABLESAMPLE", "WINDOW"}

_SCALAR_KWS = {
    "UPPER", "LOWER", "LENGTH", "CONCAT", "SUBSTRING", "TRIM", "REPLACE",
    "ABS", "CEIL", "FLOOR", "ROUND", "SQRT", "POWER", "COALESCE", "NULLIF",
    "TO_TSVECTOR", "TO_TSQUERY", "EXTRACT", "DATE_TRUNC",
    "EXP", "LN", "LOG", "LOG10", "SIGN", "MOD", "PI", "SIN", "COS", "TAN",
    "ASIN", "ACOS", "ATAN", "ATAN2", "DEGREES", "RADIANS", "TRUNC",
    "GREATEST", "LEAST", "LEFT", "RIGHT", "LPAD", "RPAD", "REVERSE",
    "INITCAP", "SPLIT_PART", "REPEAT", "LTRIM", "RTRIM", "STRPOS",
    "STARTS_WITH",
    "REGEXP_REPLACE", "REGEXP_LIKE", "REGEXP_SUBSTR", "REGEXP_COUNT",
    "STRING_TO_ARRAY", "ARRAY_TO_STRING", "ARRAY_LENGTH",
    "JSON_EXTRACT_PATH", "JSON_EXTRACT_PATH_TEXT", "JSONB_EXTRACT_PATH",
    "JSONB_EXTRACT_PATH_TEXT", "JSON_ARRAY_LENGTH", "JSON_TYPEOF",
    "JSONB_ARRAY_LENGTH", "JSONB_TYPEOF",
}
# the units an interval's quantity may name after its quotes
_QUALIFIER_UNITS = {"YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND"}
_INTERVAL_UNITS = {
    "microsecond": (0, 0, 1), "microseconds": (0, 0, 1),
    "millisecond": (0, 0, 1000), "milliseconds": (0, 0, 1000),
    "second": (0, 0, 1_000_000), "seconds": (0, 0, 1_000_000),
    "minute": (0, 0, 60_000_000), "minutes": (0, 0, 60_000_000),
    "hour": (0, 0, 3_600_000_000), "hours": (0, 0, 3_600_000_000),
    "day": (0, 1, 0), "days": (0, 1, 0),
    "week": (0, 7, 0), "weeks": (0, 7, 0),
    "month": (1, 0, 0), "months": (1, 0, 0),
    "year": (12, 0, 0), "years": (12, 0, 0),
}


def _parse_interval(text: str) -> "ast.IntervalLit":
    """Parse "<n> <unit> [<n> <unit> ...]" or "HH:MM:SS[.ffffff]" into PG's
    (months, days, micros) triple."""
    months = days = micros = 0
    toks = text.strip().split()
    i = 0
    while i < len(toks):
        tok = toks[i]
        if ":" in tok:  # HH:MM:SS[.us]
            parts = tok.split(":")
            if len(parts) not in (2, 3):
                raise ParseError(f"bad interval time {tok!r}")
            h = int(parts[0])
            m = int(parts[1])
            sec = float(parts[2]) if len(parts) == 3 else 0.0
            sign = -1 if tok.startswith("-") else 1
            micros += sign * (
                abs(h) * 3_600_000_000 + m * 60_000_000 + int(round(sec * 1e6))
            )
            i += 1
            continue
        try:
            n = float(tok) if "." in tok else int(tok)
        except ValueError:
            raise ParseError(f"bad interval quantity {tok!r}")
        if i + 1 >= len(toks):
            raise ParseError(f"interval quantity {tok!r} needs a unit")
        unit = toks[i + 1].lower()
        if unit not in _INTERVAL_UNITS:
            raise ParseError(f"unknown interval unit {unit!r}")
        um, ud, uu = _INTERVAL_UNITS[unit]
        months += int(n * um)
        days += int(n * ud)
        micros += int(n * uu)
        i += 2
    return ast.IntervalLit(months, days, micros)


_TYPE_START_KWS = {
    "INT", "INTEGER", "BIGINT", "SMALLINT", "TINYINT", "FLOAT", "REAL",
    "DOUBLE", "TEXT", "VARCHAR", "CHAR", "BOOLEAN", "BOOL", "DATE",
    "TIMESTAMP", "TIME", "DECIMAL", "NUMERIC", "UUID", "JSON", "JSONB",
    "INTERVAL", "SERIAL",
}

_CMP_OPS = {
    "=": ast.BinaryOperator.EQ,
    "!=": ast.BinaryOperator.NEQ,
    "<>": ast.BinaryOperator.NEQ,
    "<": ast.BinaryOperator.LT,
    "<=": ast.BinaryOperator.LTE,
    ">": ast.BinaryOperator.GT,
    ">=": ast.BinaryOperator.GTE,
    "@@": ast.BinaryOperator.TS_MATCH,
}


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.pos = 0

    # ---- token helpers -------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.tokens[self.pos]

    def peek(self, k: int = 1) -> Token:
        i = self.pos + k
        return self.tokens[i] if i < len(self.tokens) else self.tokens[-1]

    def advance(self) -> Token:
        t = self.cur
        if self.pos < len(self.tokens) - 1:
            self.pos += 1
        return t

    def match_kw(self, *kws: str) -> bool:
        if self.cur.is_kw(*kws):
            self.advance()
            return True
        return False

    def match_op(self, *ops: str) -> bool:
        if self.cur.is_op(*ops):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.match_kw(kw):
            raise ParseError(f"expected {kw}, found {self.cur.value or 'EOF'}")

    def expect_op(self, op: str) -> None:
        if not self.match_op(op):
            raise ParseError(f"expected '{op}', found {self.cur.value or 'EOF'}")

    def expect_alias(self) -> str:
        """Aliases after AS may be any non-reserved word incl. function
        keywords (SELECT AVG(x) AS avg)."""
        t = self.cur
        if t.kind in ("IDENT", "KEYWORD"):
            self.advance()
            return t.value if t.kind == "IDENT" else t.value.lower()
        raise ParseError(f"expected alias, found {t.value or 'EOF'}")

    def expect_ident(self) -> str:
        t = self.cur
        if t.kind == "IDENT":
            self.advance()
            return t.value
        # Permit non-reserved keywords as identifiers where unambiguous.
        if t.kind == "KEYWORD" and t.value in _TYPE_START_KWS | {
            "LEFT", "RIGHT", "ROW", "HASH", "BTREE", "DO", "NOTHING", "ALL",
        }:
            self.advance()
            return t.value.lower()
        raise ParseError(f"expected identifier, found {t.value or 'EOF'}")

    # ---- entry points --------------------------------------------------
    def parse(self) -> ast.Statement:
        stmt = self.parse_statement()
        self.match_op(";")
        if self.cur.kind != "EOF":
            raise ParseError(f"unexpected trailing input at {self.cur.value!r}")
        return stmt

    def parse_many(self) -> List[ast.Statement]:
        stmts = []
        while self.cur.kind != "EOF":
            stmts.append(self.parse_statement())
            while self.match_op(";"):
                pass
        return stmts

    def parse_statement(self) -> ast.Statement:
        t = self.cur
        if t.is_kw("SELECT") or t.is_op("("):
            return ast.Select(self.parse_select())
        if t.is_kw("VALUES"):
            # standalone VALUES (...), (...) [ORDER BY ...] [LIMIT n] —
            # sugar for SELECT * FROM (VALUES ...) with PG column1.. names
            self.advance()
            rows = [tuple(self._parse_value_row())]
            while self.match_op(","):
                rows.append(tuple(self._parse_value_row()))
            sel = ast.SelectStatement(
                projection=[ast.WildcardItem()],
                from_=ast.ValuesRef(tuple(rows)),
            )
            if self.cur.is_kw("ORDER"):
                self.advance()
                self.expect_kw("BY")
                sel.order_by.append(self.parse_order_by_expr())
                while self.match_op(","):
                    sel.order_by.append(self.parse_order_by_expr())
            if self.match_kw("LIMIT"):
                sel.limit = self._parse_usize()
            if self.match_kw("OFFSET"):
                sel.offset = self._parse_usize()
            return ast.Select(sel)
        if t.is_kw("WITH"):
            return self.parse_with_select()
        if t.is_kw("CREATE"):
            return self.parse_create()
        if t.is_kw("DROP"):
            return self.parse_drop()
        if t.kind == "IDENT" and t.value.upper() == "TRUNCATE":
            self.advance()
            self.match_kw("TABLE")
            return ast.Truncate(self.expect_ident())
        if t.kind == "IDENT" and t.value.upper() == "ALTER":
            return self.parse_alter()
        if t.is_kw("INSERT"):
            return self.parse_insert()
        if t.is_kw("UPDATE"):
            return self.parse_update()
        if t.is_kw("DELETE"):
            return self.parse_delete()
        word = t.value.upper() if t.kind in ("IDENT", "KEYWORD") else ""
        if word in ("BEGIN", "START", "COMMIT", "END", "ROLLBACK",
                    "SAVEPOINT", "RELEASE"):
            return self.parse_transaction(word)
        raise ParseError(f"unexpected token {t.value!r} at start of statement")

    def parse_transaction(self, word: str) -> ast.Transaction:
        """BEGIN [WORK|TRANSACTION] | START TRANSACTION | COMMIT | END |
        ROLLBACK [TO [SAVEPOINT] s] | SAVEPOINT s | RELEASE [SAVEPOINT] s."""
        self.advance()

        def eat_noise():
            if self.cur.kind in ("IDENT", "KEYWORD") and \
                    self.cur.value.upper() in ("WORK", "TRANSACTION"):
                self.advance()

        if word in ("BEGIN", "START"):
            eat_noise()
            return ast.Transaction("begin")
        if word in ("COMMIT", "END"):
            eat_noise()
            return ast.Transaction("commit")
        if word == "SAVEPOINT":
            return ast.Transaction("savepoint", self.expect_ident())
        if word == "RELEASE":
            if self.cur.kind in ("IDENT", "KEYWORD") and \
                    self.cur.value.upper() == "SAVEPOINT":
                self.advance()
            return ast.Transaction("release", self.expect_ident())
        # ROLLBACK
        eat_noise()
        if self.cur.kind in ("IDENT", "KEYWORD") and \
                self.cur.value.upper() == "TO":
            self.advance()
            if self.cur.kind in ("IDENT", "KEYWORD") and \
                    self.cur.value.upper() == "SAVEPOINT":
                self.advance()
            return ast.Transaction("rollback_to", self.expect_ident())
        return ast.Transaction("rollback")

    # ---- SELECT --------------------------------------------------------
    def parse_select(self) -> ast.SelectStatement:
        if self.match_op("("):
            inner = self.parse_select()
            self.expect_op(")")
            sel = inner
        else:
            sel = self.parse_select_core()
        # set operations chain
        while self.cur.is_kw("UNION", "INTERSECT", "EXCEPT"):
            kw = self.advance().value
            if kw == "UNION":
                op = (
                    ast.SetOperation.UNION_ALL
                    if self.match_kw("ALL")
                    else ast.SetOperation.UNION
                )
            elif kw == "INTERSECT":
                op = ast.SetOperation.INTERSECT
            else:
                op = ast.SetOperation.EXCEPT
            if self.match_op("("):
                rhs = self.parse_select()
                self.expect_op(")")
            else:
                rhs = self.parse_select_core()
            sel.union_clause = ast.UnionClause(op, rhs)
            sel = self._wrap_union_tail(sel)
        return sel

    @staticmethod
    def _wrap_union_tail(sel: ast.SelectStatement) -> ast.SelectStatement:
        # ORDER BY/LIMIT after a UNION apply to the combined result; the
        # reference keeps them on the left select (ast.rs SelectStatement),
        # and so do we.
        return sel

    def parse_select_core(self) -> ast.SelectStatement:
        self.expect_kw("SELECT")
        sel = ast.SelectStatement()
        if self.match_kw("DISTINCT"):
            if self.match_kw("ON"):
                self.expect_op("(")
                cols = [self.parse_expr()]
                while self.match_op(","):
                    cols.append(self.parse_expr())
                self.expect_op(")")
                sel.distinct_on = cols
            else:
                sel.distinct = True
        # projection
        sel.projection.append(self.parse_select_item())
        while self.match_op(","):
            sel.projection.append(self.parse_select_item())
        # FROM
        if self.match_kw("FROM"):
            sel.from_ = self.parse_table_reference()
            while True:
                if self.match_op(","):
                    sel.joins.append(
                        ast.Join(ast.JoinType.CROSS, self.parse_table_reference())
                    )
                    continue
                natural = False
                if self._match_word("NATURAL"):
                    natural = True
                jt = self._try_parse_join_type()
                if jt is None:
                    if natural:
                        raise ParseError("expected JOIN after NATURAL")
                    break
                right = self.parse_table_reference()
                on = None
                using: tuple = ()
                if jt is not ast.JoinType.CROSS and not natural:
                    if self.match_kw("USING"):
                        self.expect_op("(")
                        cols = [self.expect_ident()]
                        while self.match_op(","):
                            cols.append(self.expect_ident())
                        self.expect_op(")")
                        using = tuple(cols)
                    else:
                        self.expect_kw("ON")
                        on = self.parse_expr()
                sel.joins.append(ast.Join(jt, right, on, using, natural))
        if self.match_kw("WHERE"):
            sel.selection = self.parse_expr()
        if self.cur.is_kw("GROUP"):
            self.advance()
            self.expect_kw("BY")
            if self.cur.is_kw("ROLLUP", "CUBE"):
                kind = self.advance().value
                self.expect_op("(")
                sel.group_by.append(self.parse_expr())
                while self.match_op(","):
                    sel.group_by.append(self.parse_expr())
                self.expect_op(")")
                n = len(sel.group_by)
                if kind == "ROLLUP":
                    sel.grouping_sets = [
                        list(range(k)) for k in range(n, -1, -1)
                    ]
                else:  # CUBE: all subsets, larger sets first
                    import itertools

                    sel.grouping_sets = [
                        list(c)
                        for k in range(n, -1, -1)
                        for c in itertools.combinations(range(n), k)
                    ]
            elif self.cur.is_kw("GROUPING"):
                self.advance()
                self.expect_kw("SETS")
                self.expect_op("(")
                sets_exprs: List[List[ast.Expr]] = []
                while True:
                    one: List[ast.Expr] = []
                    if self.match_op("("):
                        if not self.cur.is_op(")"):
                            one.append(self.parse_expr())
                            while self.match_op(","):
                                one.append(self.parse_expr())
                        self.expect_op(")")
                    else:
                        one.append(self.parse_expr())
                    sets_exprs.append(one)
                    if not self.match_op(","):
                        break
                self.expect_op(")")
                # distinct exprs (frozen dataclasses compare by value)
                sel.grouping_sets = []
                for one in sets_exprs:
                    idxs = []
                    for e in one:
                        if e in sel.group_by:
                            idxs.append(sel.group_by.index(e))
                        else:
                            sel.group_by.append(e)
                            idxs.append(len(sel.group_by) - 1)
                    sel.grouping_sets.append(idxs)
            else:
                sel.group_by.append(self.parse_expr())
                while self.match_op(","):
                    sel.group_by.append(self.parse_expr())
        if self.match_kw("HAVING"):
            sel.having = self.parse_expr()
        named_windows = {}
        if self._match_word("WINDOW"):
            while True:
                nm = self.expect_ident()
                self.expect_kw("AS")
                if not self.cur.is_op("("):
                    raise ParseError("expected ( after WINDOW name AS")
                spec = self.parse_window_spec()
                named_windows[nm.lower()] = spec
                if not self.match_op(","):
                    break
        if self.cur.is_kw("ORDER"):
            self.advance()
            self.expect_kw("BY")
            sel.order_by.append(self.parse_order_by_expr())
            while self.match_op(","):
                sel.order_by.append(self.parse_order_by_expr())
        if self.match_kw("LIMIT"):
            sel.limit = self._parse_usize()
        if self.match_kw("OFFSET"):
            sel.offset = self._parse_usize()
            self._match_word("ROW", "ROWS")  # PG noise words
        if self._match_word("FETCH"):
            # FETCH {FIRST|NEXT} [n] {ROW|ROWS} ONLY — SQL-standard LIMIT
            if not self._match_word("FIRST", "NEXT"):
                raise ParseError("expected FIRST or NEXT after FETCH")
            n = 1
            if self.cur.kind == "NUMBER":
                n = self._parse_usize()
            if not self._match_word("ROW", "ROWS"):
                raise ParseError("expected ROW or ROWS in FETCH clause")
            if not self._match_word("ONLY"):
                raise ParseError(
                    "only FETCH ... ROWS ONLY is supported (no WITH TIES)"
                )
            sel.limit = n
        self._resolve_window_refs(sel, named_windows)
        return sel

    def _resolve_window_refs(self, sel: ast.SelectStatement,
                             windows: dict) -> None:
        """Patch every `OVER name` WindowSpec with its WINDOW-clause
        definition (frozen dataclasses are patched in place — the clause
        appears after the projection, so references parse first)."""
        import dataclasses

        seen = set()

        def walk(x):
            if x is None or id(x) in seen:
                return
            if isinstance(x, ast.WindowSpec):
                seen.add(id(x))
                if x.ref is None:
                    return
                spec = windows.get(x.ref.lower())
                if spec is None:
                    raise ParseError(f'window "{x.ref}" is not defined')
                for f in ("partition_by", "order_by", "frame"):
                    object.__setattr__(x, f, getattr(spec, f))
                object.__setattr__(x, "ref", None)
                return
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                seen.add(id(x))
                for f in dataclasses.fields(x):
                    walk(getattr(x, f.name))
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)

        for it in sel.projection:
            walk(it)
        for ob in sel.order_by:
            walk(ob)
        if sel.having is not None:
            walk(sel.having)

    def _match_word(self, *names: str) -> bool:
        """Match-and-consume a non-reserved word that may lex as IDENT or
        KEYWORD (NATURAL, FETCH, FIRST, ROWS, ONLY...)."""
        t = self.cur
        if t.kind in ("IDENT", "KEYWORD") and t.value.upper() in names:
            self.advance()
            return True
        return False

    def _parse_usize(self) -> int:
        t = self.cur
        if t.kind != "NUMBER":
            raise ParseError(f"expected number, found {t.value!r}")
        self.advance()
        try:
            return int(t.value)
        except ValueError:
            raise ParseError(f"expected integer, found {t.value!r}")

    def _try_parse_join_type(self) -> Optional[ast.JoinType]:
        t = self.cur
        if t.is_kw("JOIN"):
            self.advance()
            return ast.JoinType.INNER
        if t.is_kw("INNER"):
            self.advance()
            self.expect_kw("JOIN")
            return ast.JoinType.INNER
        if t.is_kw("LEFT", "RIGHT", "FULL") and self.peek().is_kw("OUTER", "JOIN"):
            kind = self.advance().value
            self.match_kw("OUTER")
            self.expect_kw("JOIN")
            return ast.JoinType[kind]
        if t.is_kw("CROSS"):
            self.advance()
            self.expect_kw("JOIN")
            return ast.JoinType.CROSS
        return None

    def parse_select_item(self) -> ast.SelectItem:
        if self.cur.is_op("*"):
            self.advance()
            return ast.WildcardItem()
        if (
            self.cur.kind == "IDENT"
            and self.peek().is_op(".")
            and self.peek(2).is_op("*")
        ):
            table = self.advance().value
            self.advance()  # .
            self.advance()  # *
            return ast.QualifiedWildcard(table)
        expr = self.parse_expr()
        alias = None
        if self.match_kw("AS"):
            alias = self.expect_alias()
        elif self.cur.kind == "IDENT":
            alias = self.advance().value
        return ast.ExprItem(expr, alias)

    def parse_table_reference(self) -> ast.TableReference:
        # LATERAL is accepted and a no-op marker: UNNEST/GENERATE_SERIES
        # FROM items are already implicitly lateral (they may reference
        # earlier FROM items), matching PG's "LATERAL is implied for
        # table functions". Correlated LATERAL subqueries surface a
        # normal unknown-column planning error.
        if self.cur.kind == "IDENT" and self.cur.value.upper() == "LATERAL":
            self.advance()
        if self.match_op("("):
            if self.cur.is_kw("VALUES"):
                self.advance()
                rows = [tuple(self._parse_value_row())]
                while self.match_op(","):
                    rows.append(tuple(self._parse_value_row()))
                self.expect_op(")")
                self.match_kw("AS")
                alias = "values"
                cols: tuple = ()
                if self.cur.kind == "IDENT":
                    alias = self.advance().value
                    if self.match_op("("):
                        names = [self.expect_ident()]
                        while self.match_op(","):
                            names.append(self.expect_ident())
                        self.expect_op(")")
                        cols = tuple(names)
                return ast.ValuesRef(tuple(rows), alias, cols)
            query = self.parse_select()
            self.expect_op(")")
            self.match_kw("AS")
            alias = self.expect_alias()
            cols = ()
            if self.match_op("("):
                # a derived table's column list renames its columns in order
                names = [self.expect_ident()]
                while self.match_op(","):
                    names.append(self.expect_ident())
                self.expect_op(")")
                cols = tuple(names)
            return ast.SubqueryRef(query, alias, cols)
        name = self.expect_ident()
        if name.upper() == "UNNEST" and self.cur.is_op("("):
            self.advance()
            expr = self.parse_expr()
            self.expect_op(")")
            self.match_kw("AS")
            alias, col = "unnest", ""
            if self.cur.kind == "IDENT" and \
                    self.cur.value.upper() not in _NON_ALIAS_WORDS:
                alias = self.advance().value
                if self.match_op("("):
                    col = self.expect_ident()
                    self.expect_op(")")
            return ast.UnnestRef(expr, alias, col)
        if name.upper() == "GENERATE_SERIES" and self.cur.is_op("("):
            self.advance()
            args = [self.parse_expr()]
            while self.match_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            self.match_kw("AS")
            alias, cols = name.lower(), ()
            if self.cur.kind == "IDENT" and \
                    self.cur.value.upper() not in _NON_ALIAS_WORDS:
                alias = self.advance().value
                if self.match_op("("):
                    names = [self.expect_ident()]
                    while self.match_op(","):
                        names.append(self.expect_ident())
                    self.expect_op(")")
                    cols = tuple(names)
            return ast.TableFnRef("generate_series", tuple(args), alias, cols)
        alias = None
        if self.match_kw("AS"):
            alias = self.expect_alias()
        elif (self.cur.kind == "IDENT"
              and self.cur.value.upper() not in _NON_ALIAS_WORDS):
            alias = self.advance().value
        return ast.TableName(name, alias)

    def parse_order_by_expr(self) -> ast.OrderByExpr:
        expr = self.parse_expr()
        asc = True
        if self.match_kw("DESC"):
            asc = False
        else:
            self.match_kw("ASC")
        nulls_first = None
        if self.cur.kind == "IDENT" and self.cur.value.upper() == "NULLS":
            self.advance()
            nxt = self.expect_ident().upper()
            if nxt == "FIRST":
                nulls_first = True
            elif nxt == "LAST":
                nulls_first = False
            else:
                raise ParseError(f"expected FIRST or LAST after NULLS, got {nxt}")
        return ast.OrderByExpr(expr, asc, nulls_first)

    # ---- WITH ----------------------------------------------------------
    def parse_with_select(self) -> ast.WithSelect:
        self.expect_kw("WITH")
        recursive = self.match_kw("RECURSIVE")
        ctes = [self.parse_cte()]
        while self.match_op(","):
            ctes.append(self.parse_cte())
        select = self.parse_select()
        return ast.WithSelect(recursive, ctes, select)

    def parse_cte(self) -> ast.CteDefinition:
        name = self.expect_ident()
        columns = None
        if self.match_op("("):
            cols = [self.expect_ident()]
            while self.match_op(","):
                cols.append(self.expect_ident())
            self.expect_op(")")
            columns = tuple(cols)
        self.expect_kw("AS")
        self.expect_op("(")
        query = self.parse_select()
        self.expect_op(")")
        return ast.CteDefinition(name, columns, query)

    # ---- DDL -----------------------------------------------------------
    def parse_create(self) -> ast.Statement:
        self.expect_kw("CREATE")
        or_replace = False
        if self.match_kw("OR"):
            if not self._match_word("REPLACE"):
                raise ParseError("expected REPLACE after CREATE OR")
            or_replace = True
        if self._match_word("VIEW"):
            name = self.expect_ident()
            cols: tuple = ()
            if self.match_op("("):
                names = [self.expect_ident()]
                while self.match_op(","):
                    names.append(self.expect_ident())
                self.expect_op(")")
                cols = tuple(names)
            self.expect_kw("AS")
            if self.cur.is_kw("WITH"):
                body: ast.Statement = self.parse_with_select()
            else:
                body = ast.Select(self.parse_select())
            return ast.CreateView(name, body, cols, or_replace)
        if or_replace:
            raise ParseError("OR REPLACE only valid for CREATE VIEW")
        unique = self.match_kw("UNIQUE")
        if self.match_kw("INDEX"):
            name = self.expect_ident()
            self.expect_kw("ON")
            table = self.expect_ident()
            self.expect_op("(")
            columns = [self.expect_ident()]
            while self.match_op(","):
                columns.append(self.expect_ident())
            self.expect_op(")")
            index_type = ast.IndexType.BTREE
            if self.match_kw("USING"):
                if self.match_kw("HASH"):
                    index_type = ast.IndexType.HASH
                elif self.match_kw("BTREE"):
                    index_type = ast.IndexType.BTREE
                else:
                    raise ParseError(
                        f"expected BTREE or HASH, found {self.cur.value!r}"
                    )
            return ast.CreateIndex(name, table, columns, unique, index_type)
        if unique:
            raise ParseError("UNIQUE only valid for CREATE UNIQUE INDEX")
        if self.match_kw("TABLE"):
            if_not_exists = False
            if self.match_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                if_not_exists = True
            name = self.expect_ident()
            if self.match_kw("AS"):
                # CREATE TABLE t AS select (CTAS)
                body = (self.parse_with_select() if self.cur.is_kw("WITH")
                        else ast.Select(self.parse_select()))
                return ast.CreateTableAs(name, body, if_not_exists)
            self.expect_op("(")
            columns = [self.parse_column_def()]
            while self.match_op(","):
                columns.append(self.parse_column_def())
            self.expect_op(")")
            return ast.CreateTable(name, columns, if_not_exists)
        raise ParseError(f"expected INDEX or TABLE after CREATE, found {self.cur.value!r}")

    def parse_column_def(self) -> ast.ColumnDef:
        name = self.expect_ident()
        serial = (
            self.cur.is_kw("SERIAL")
            or (self.cur.kind == "IDENT"
                and self.cur.value.upper() == "BIGSERIAL")
        )
        if serial and self.cur.kind == "IDENT":
            self.advance()  # BIGSERIAL lexes as IDENT; SERIAL via type path
            dtype = DataType.int64()
        else:
            dtype = self.parse_data_type()
        nullable = not serial
        while True:
            if self.match_kw("NOT"):
                self.expect_kw("NULL")
                nullable = False
            elif self.match_kw("NULL"):
                nullable = True
            elif self.cur.kind == "IDENT" and self.cur.value.upper() in (
                "PRIMARY", "KEY", "DEFAULT",
            ):
                # tolerated & ignored constraint tokens
                self.advance()
            else:
                break
        return ast.ColumnDef(name, dtype, nullable, serial)

    def parse_alter(self) -> ast.Statement:
        self.advance()  # ALTER
        self.expect_kw("TABLE")
        table = self.expect_ident()
        if self._match_word("ADD"):
            self._match_word("COLUMN")
            return ast.AlterTable(table, "add",
                                  column=self.parse_column_def())
        if self.match_kw("DROP"):
            self._match_word("COLUMN")
            return ast.AlterTable(table, "drop", name=self.expect_ident())
        if self._match_word("RENAME"):
            if self._match_word("TO"):
                return ast.AlterTable(table, "rename_table",
                                      name=self.expect_ident())
            self._match_word("COLUMN")
            old = self.expect_ident()
            if not self._match_word("TO"):
                raise ParseError("expected TO in ALTER TABLE RENAME")
            return ast.AlterTable(table, "rename_column", name=old,
                                  new_name=self.expect_ident())
        raise ParseError(
            "expected ADD, DROP, or RENAME after ALTER TABLE <name>"
        )

    def parse_drop(self) -> ast.Statement:
        self.expect_kw("DROP")
        if self.match_kw("INDEX"):
            if_exists = False
            if self.match_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            name = self.expect_ident()
            return ast.DropIndex(name, if_exists)
        if self._match_word("VIEW"):
            if_exists = False
            if self.match_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            return ast.DropView(self.expect_ident(), if_exists)
        if self.match_kw("TABLE"):
            if_exists = False
            if self.match_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            return ast.DropTable(self.expect_ident(), if_exists)
        raise ParseError("expected INDEX, TABLE, or VIEW after DROP")

    # ---- DML -----------------------------------------------------------
    def parse_insert(self) -> ast.Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.expect_ident()
        columns = None
        if self.match_op("("):
            columns = [self.expect_ident()]
            while self.match_op(","):
                columns.append(self.expect_ident())
            self.expect_op(")")
        query = None
        if self.cur.is_kw("SELECT", "WITH"):
            query = (self.parse_with_select() if self.cur.is_kw("WITH")
                     else ast.Select(self.parse_select()))
            values: List[List[ast.Expr]] = []
        else:
            self.expect_kw("VALUES")
            values = [self._parse_value_row()]
            while self.match_op(","):
                values.append(self._parse_value_row())
        on_conflict = None
        if self.match_kw("ON"):
            self.expect_kw("CONFLICT")
            self.expect_op("(")
            ccols = [self.expect_ident()]
            while self.match_op(","):
                ccols.append(self.expect_ident())
            self.expect_op(")")
            self.expect_kw("DO")
            if self.match_kw("NOTHING"):
                action: ast.ConflictAction = ast.DoNothing()
            else:
                self.expect_kw("UPDATE")
                self.expect_kw("SET")
                assigns = [self._parse_assignment()]
                while self.match_op(","):
                    assigns.append(self._parse_assignment())
                action = ast.DoUpdate(tuple(assigns))
            on_conflict = ast.OnConflictClause(tuple(ccols), action)
        returning = self._parse_returning()
        return ast.Insert(table, columns, values, on_conflict, returning,
                          query)

    def _parse_value_row(self) -> List[ast.Expr]:
        self.expect_op("(")
        row = [self.parse_expr()]
        while self.match_op(","):
            row.append(self.parse_expr())
        self.expect_op(")")
        return row

    def _parse_assignment(self) -> ast.Assignment:
        col = self.expect_ident()
        self.expect_op("=")
        return ast.Assignment(col, self.parse_expr())

    def _parse_returning(self) -> Optional[List[ast.SelectItem]]:
        if not self.match_kw("RETURNING"):
            return None
        items = [self.parse_select_item()]
        while self.match_op(","):
            items.append(self.parse_select_item())
        return items

    def parse_update(self) -> ast.Update:
        self.expect_kw("UPDATE")
        table = self.expect_ident()
        self.expect_kw("SET")
        assigns = [self._parse_assignment()]
        while self.match_op(","):
            assigns.append(self._parse_assignment())
        from_table = None
        if self.match_kw("FROM"):
            from_table = self.parse_table_reference()
        selection = self.parse_expr() if self.match_kw("WHERE") else None
        returning = self._parse_returning()
        return ast.Update(table, assigns, selection, returning, from_table)

    def parse_delete(self) -> ast.Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self.expect_ident()
        using = None
        if self.match_kw("USING"):
            using = self.parse_table_reference()
        selection = self.parse_expr() if self.match_kw("WHERE") else None
        returning = self._parse_returning()
        return ast.Delete(table, selection, returning, using)

    # ---- expressions ---------------------------------------------------
    def parse_expr(self) -> ast.Expr:
        return self.parse_or()

    def parse_or(self) -> ast.Expr:
        left = self.parse_and()
        while self.match_kw("OR"):
            left = ast.BinaryOp(left, ast.BinaryOperator.OR, self.parse_and())
        return left

    def parse_and(self) -> ast.Expr:
        left = self.parse_not()
        while self.match_kw("AND"):
            left = ast.BinaryOp(left, ast.BinaryOperator.AND, self.parse_not())
        return left

    def parse_not(self) -> ast.Expr:
        if self.match_kw("NOT"):
            return ast.UnaryOp(ast.UnaryOperator.NOT, self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Expr:
        left = self.parse_additive()
        while True:
            t = self.cur
            if t.kind == "OP" and t.value in _CMP_OPS:
                self.advance()
                if self.cur.is_kw("ANY", "SOME", "ALL") and \
                        self.peek().is_op("("):
                    q = self.advance().value
                    self.expect_op("(")
                    query = self.parse_select()
                    self.expect_op(")")
                    left = ast.QuantifiedComparison(
                        left, _CMP_OPS[t.value], q != "ALL", query
                    )
                    continue
                left = ast.BinaryOp(left, _CMP_OPS[t.value], self.parse_additive())
            elif t.is_kw("LIKE", "ILIKE"):
                self.advance()
                op = (
                    ast.BinaryOperator.LIKE
                    if t.value == "LIKE"
                    else ast.BinaryOperator.ILIKE
                )
                left = ast.BinaryOp(left, op, self.parse_additive())
            elif t.is_op("~", "~*", "!~", "!~*"):
                self.advance()
                op = {
                    "~": ast.BinaryOperator.REGEX_MATCH,
                    "~*": ast.BinaryOperator.REGEX_IMATCH,
                    "!~": ast.BinaryOperator.NOT_REGEX_MATCH,
                    "!~*": ast.BinaryOperator.NOT_REGEX_IMATCH,
                }[t.value]
                left = ast.BinaryOp(left, op, self.parse_additive())
            elif t.is_kw("SIMILAR"):
                self.advance()
                if not self._match_word("TO"):
                    raise ParseError("expected TO after SIMILAR")
                left = ast.BinaryOp(
                    left, ast.BinaryOperator.SIMILAR_TO, self.parse_additive()
                )
            elif t.is_kw("IS"):
                self.advance()
                negated = self.match_kw("NOT")
                if self.match_kw("DISTINCT"):
                    # IS [NOT] DISTINCT FROM: null-safe (in)equality,
                    # desugared to a CASE so every path inherits it
                    self.expect_kw("FROM")
                    right = self.parse_additive()
                    both_null = ast.BinaryOp(
                        ast.IsNull(left, False), ast.BinaryOperator.AND,
                        ast.IsNull(right, False),
                    )
                    either_null = ast.BinaryOp(
                        ast.IsNull(left, False), ast.BinaryOperator.OR,
                        ast.IsNull(right, False),
                    )
                    same = ast.Case(None, (
                        (both_null, ast.BoolLit(True)),
                        (either_null, ast.BoolLit(False)),
                        (ast.BinaryOp(left, ast.BinaryOperator.EQ, right),
                         ast.BoolLit(True)),
                    ), ast.BoolLit(False))
                    left = (same if negated
                            else ast.UnaryOp(ast.UnaryOperator.NOT, same))
                    continue
                self.expect_kw("NULL")
                left = ast.IsNull(left, negated)
            elif t.is_kw("BETWEEN"):
                self.advance()
                low = self.parse_additive()
                self.expect_kw("AND")
                high = self.parse_additive()
                left = ast.Between(left, low, high, negated=False)
            elif t.is_kw("IN"):
                self.advance()
                left = self._parse_in_tail(left, negated=False)
            elif t.is_kw("NOT") and self.peek().is_kw(
                "IN", "LIKE", "ILIKE", "BETWEEN", "SIMILAR"
            ):
                self.advance()
                nxt = self.advance()
                if nxt.value == "SIMILAR":
                    if not self._match_word("TO"):
                        raise ParseError("expected TO after SIMILAR")
                    left = ast.BinaryOp(
                        left, ast.BinaryOperator.NOT_SIMILAR_TO,
                        self.parse_additive(),
                    )
                elif nxt.value == "IN":
                    left = self._parse_in_tail(left, negated=True)
                elif nxt.value == "BETWEEN":
                    low = self.parse_additive()
                    self.expect_kw("AND")
                    high = self.parse_additive()
                    left = ast.Between(left, low, high, negated=True)
                else:
                    op = (
                        ast.BinaryOperator.NOT_LIKE
                        if nxt.value == "LIKE"
                        else ast.BinaryOperator.NOT_ILIKE
                    )
                    left = ast.BinaryOp(left, op, self.parse_additive())
            else:
                return left

    def _parse_in_tail(self, left: ast.Expr, negated: bool) -> ast.Expr:
        self.expect_op("(")
        if self.cur.is_kw("SELECT", "WITH"):
            query = self.parse_select()
            self.expect_op(")")
            return ast.InSubquery(left, query, negated)
        items = [self.parse_expr()]
        while self.match_op(","):
            items.append(self.parse_expr())
        self.expect_op(")")
        return ast.InList(left, tuple(items), negated)

    def parse_additive(self) -> ast.Expr:
        left = self.parse_multiplicative()
        while True:
            if self.match_op("+"):
                left = ast.BinaryOp(left, ast.BinaryOperator.PLUS, self.parse_multiplicative())
            elif self.match_op("-"):
                left = ast.BinaryOp(left, ast.BinaryOperator.MINUS, self.parse_multiplicative())
            elif self.match_op("||"):
                left = ast.BinaryOp(left, ast.BinaryOperator.CONCAT_OP, self.parse_multiplicative())
            else:
                return left

    def parse_multiplicative(self) -> ast.Expr:
        left = self.parse_unary()
        while True:
            if self.match_op("*"):
                left = ast.BinaryOp(left, ast.BinaryOperator.MULTIPLY, self.parse_unary())
            elif self.match_op("/"):
                left = ast.BinaryOp(left, ast.BinaryOperator.DIVIDE, self.parse_unary())
            elif self.match_op("%"):
                left = ast.BinaryOp(left, ast.BinaryOperator.MODULO, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> ast.Expr:
        if self.match_op("-"):
            return ast.UnaryOp(ast.UnaryOperator.MINUS, self.parse_unary())
        if self.match_op("+"):
            return self.parse_unary()
        return self.parse_postfix()

    _JSON_OPS = {
        "->": ast.BinaryOperator.JSON_GET,
        "->>": ast.BinaryOperator.JSON_GET_TEXT,
        "#>": ast.BinaryOperator.JSON_PATH,
        "#>>": ast.BinaryOperator.JSON_PATH_TEXT,
    }

    def parse_postfix(self) -> ast.Expr:
        expr = self.parse_primary()
        while True:
            if self.match_op("::"):
                expr = ast.Cast(expr, self.parse_data_type())
                continue
            if self.cur.kind == "OP" and self.cur.value in self._JSON_OPS:
                op = self._JSON_OPS[self.advance().value]
                # key: string/number literal (or -n for negative indexes)
                neg = self.match_op("-")
                rhs = self.parse_primary()
                if neg:
                    rhs = ast.UnaryOp(ast.UnaryOperator.MINUS, rhs)
                expr = ast.BinaryOp(expr, op, rhs)
                continue
            return expr

    def parse_primary(self) -> ast.Expr:
        t = self.cur
        if t.kind == "NUMBER":
            self.advance()
            return ast.NumberLit(t.value)
        if t.kind == "STRING":
            self.advance()
            return ast.StringLit(t.value)
        if t.kind == "PARAM":
            self.advance()
            return ast.Param(int(t.value[1:]))
        if t.is_kw("TRUE"):
            self.advance()
            return ast.BoolLit(True)
        if t.is_kw("FALSE"):
            self.advance()
            return ast.BoolLit(False)
        if t.is_kw("NULL"):
            self.advance()
            return ast.NullLit()
        if t.is_kw("GROUPING") and self.peek().is_op("("):
            self.advance()
            self.advance()
            args = [self.parse_expr()]
            while self.match_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return ast.GroupingCall(tuple(args))
        if t.is_kw("INTERVAL") and self.peek().kind == "STRING":
            self.advance()
            text = self.advance().value
            return _parse_interval(text + self._interval_qualifier())
        if (t.is_kw("DATE", "TIMESTAMP") and self.peek().kind == "STRING"):
            # typed literals DATE '...' / TIMESTAMP '...' — sugar for the
            # string->temporal CAST (PG type 'literal' syntax)
            self.advance()
            text = self.advance().value
            dt = (DataType.date32() if t.value == "DATE"
                  else DataType.timestamp())
            return ast.Cast(ast.StringLit(text), dt)
        if (t.kind in ("IDENT", "KEYWORD") and t.value.upper() == "POSITION"
                and self.peek().is_op("(")):
            # POSITION(sub IN str) — PG special form of STRPOS(str, sub)
            self.advance()
            self.advance()
            sub = self.parse_additive()  # stop before the IN keyword
            self.expect_kw("IN")
            s = self.parse_expr()
            self.expect_op(")")
            return ast.ScalarFunctionCall(
                ast.ScalarFunction.STRPOS, (s, sub)
            )
        if t.is_kw("CAST"):
            self.advance()
            self.expect_op("(")
            inner = self.parse_expr()
            self.expect_kw("AS")
            dtype = self.parse_data_type()
            self.expect_op(")")
            return ast.Cast(inner, dtype)
        if t.is_kw("CASE"):
            return self.parse_case()
        if t.is_kw("EXISTS"):
            self.advance()
            self.expect_op("(")
            query = self.parse_select()
            self.expect_op(")")
            return ast.Exists(query, negated=False)
        if t.is_kw("NOT") and self.peek().is_kw("EXISTS"):
            self.advance()
            self.advance()
            self.expect_op("(")
            query = self.parse_select()
            self.expect_op(")")
            return ast.Exists(query, negated=True)
        if t.kind == "KEYWORD" and t.value in ("CURRENT_DATE",
                                               "CURRENT_TIMESTAMP", "NOW"):
            # statement-time constants (PG statement_timestamp granularity):
            # desugared to CAST('<now>' AS DATE/TIMESTAMP) at parse time
            import datetime as _dt

            self.advance()
            if t.value == "NOW":
                self.expect_op("(")
                self.expect_op(")")
            now = _dt.datetime.now(_dt.timezone.utc).replace(tzinfo=None)
            if t.value == "CURRENT_DATE":
                return ast.Cast(ast.StringLit(now.date().isoformat()),
                                DataType.date32())
            return ast.Cast(
                ast.StringLit(now.isoformat(sep=" ", timespec="microseconds")),
                DataType.timestamp(),
            )
        if t.kind == "KEYWORD" and t.value in _ORDERED_SET_KWS:
            return self._maybe_filter(self.parse_ordered_set_aggregate())
        if t.kind == "KEYWORD" and t.value in _AGG_KWS:
            agg = self._maybe_filter(self.parse_aggregate())
            if self.cur.is_kw("OVER"):
                self.advance()
                over = self.parse_window_spec()
                arg = None if isinstance(agg.expr, ast.Wildcard) else agg.expr
                return ast.WindowAggregate(agg.func, arg, agg.distinct, over)
            return agg
        if t.kind == "KEYWORD" and t.value in _WINDOW_KWS:
            return self.parse_window_function()
        if t.kind == "KEYWORD" and t.value in _SCALAR_KWS:
            # LEFT/RIGHT double as join keywords and identifiers; only a
            # following "(" makes them the string functions
            if t.value not in ("LEFT", "RIGHT") or self.peek().is_op("("):
                return self.parse_scalar_function()
        if t.is_op("("):
            self.advance()
            if self.cur.is_kw("SELECT", "WITH"):
                query = self.parse_select()
                self.expect_op(")")
                return ast.ScalarSubquery(query)
            inner = self.parse_expr()
            self.expect_op(")")
            return inner
        if t.kind == "IDENT" or (
            t.kind == "KEYWORD"
            and t.value in {"LEFT", "RIGHT", "ROW", "HASH", "DO"}
        ):
            name = self.advance().value
            if self.cur.is_op(".") and self.peek().kind in ("IDENT", "KEYWORD"):
                self.advance()
                col = self.expect_ident()
                return ast.QualifiedColumn(name, col)
            if self.cur.is_op("("):
                # user-defined function call
                self.advance()
                args: List[ast.Expr] = []
                if not self.cur.is_op(")"):
                    args.append(self.parse_expr())
                    while self.match_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
                call = ast.UdfCall(name, tuple(args))
                if self.cur.is_kw("OVER"):
                    raise ParseError(f"{name} is not a window function")
                return call
            return ast.Column(name)
        raise ParseError(f"unexpected token {t.value!r} in expression")

    def parse_case(self) -> ast.Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.cur.is_kw("WHEN"):
            operand = self.parse_expr()
        branches: List[Tuple[ast.Expr, ast.Expr]] = []
        while self.match_kw("WHEN"):
            when = self.parse_expr()
            self.expect_kw("THEN")
            then = self.parse_expr()
            branches.append((when, then))
        else_expr = self.parse_expr() if self.match_kw("ELSE") else None
        self.expect_kw("END")
        if not branches:
            raise ParseError("CASE requires at least one WHEN branch")
        return ast.Case(operand, tuple(branches), else_expr)

    def parse_aggregate(self) -> ast.Expr:
        fname = self.advance().value
        func = ast.AggregateFunction[fname]
        self.expect_op("(")
        distinct = self.match_kw("DISTINCT")
        if self.cur.is_op("*"):
            self.advance()
            arg: ast.Expr = ast.Wildcard()
        else:
            arg = self.parse_expr()
        if fname in _TWO_ARG_AGG_KWS:
            if distinct and fname != "STRING_AGG":
                raise ParseError(f"{fname}(DISTINCT ...) is not valid")
            self.expect_op(",")
            arg2 = self.parse_expr()
            order = self._maybe_agg_order_by(fname)
            self.expect_op(")")
            return ast.Aggregate(func, arg, distinct, expr2=arg2,
                                 agg_order_by=order)
        order = self._maybe_agg_order_by(fname)
        self.expect_op(")")
        return ast.Aggregate(func, arg, distinct, agg_order_by=order)

    def _maybe_agg_order_by(self, fname: str) -> tuple:
        """In-call ORDER BY — only the order-sensitive aggregates accept it
        (PG parses it for every aggregate but element order is only
        observable in ARRAY_AGG/STRING_AGG; rejecting elsewhere surfaces
        no-op clauses instead of silently dropping them)."""
        if not self.cur.is_kw("ORDER"):
            return ()
        if fname not in ("ARRAY_AGG", "STRING_AGG"):
            raise ParseError(
                f"ORDER BY inside {fname}(...) has no effect; it is only "
                "supported for ARRAY_AGG and STRING_AGG"
            )
        self.advance()
        self.expect_kw("BY")
        items = [self.parse_order_by_expr()]
        while self.match_op(","):
            items.append(self.parse_order_by_expr())
        return tuple(items)

    def _maybe_filter(self, agg: ast.Aggregate) -> ast.Aggregate:
        """PG `agg(...) FILTER (WHERE pred)` — desugared at parse time into
        CASE masking of the argument(s): agg(CASE WHEN pred THEN x END).
        Rows failing (or NULL under) the predicate contribute NULL, which
        every aggregate already skips, so all execution paths (eager,
        compiled, mesh, chunked, distributed) inherit FILTER for free.
        COUNT(*) FILTER counts predicate-passing rows via CASE-masked 1;
        two-argument statistics mask both arguments (pair exclusion)."""
        if not self.cur.is_kw("FILTER"):
            return agg
        self.advance()
        self.expect_op("(")
        self.expect_kw("WHERE")
        pred = self.parse_expr()
        self.expect_op(")")
        if agg.func is ast.AggregateFunction.ARRAY_AGG:
            # ARRAY_AGG KEEPS NULL inputs (PG), so the CASE desugar would
            # surface excluded rows as NULL elements instead of dropping
            # them; carry the predicate and exclude rows at finalization
            return ast.Aggregate(
                agg.func, agg.expr, agg.distinct, agg.param, agg.expr2,
                agg.agg_order_by, pred,
            )

        def mask(e: ast.Expr) -> ast.Expr:
            return ast.Case(None, ((pred, e),), None)

        if isinstance(agg.expr, ast.Wildcard):
            return ast.Aggregate(
                agg.func, mask(ast.NumberLit("1")), agg.distinct, agg.param
            )
        # STRING_AGG's second argument is the delimiter, not a value column
        mask2 = (mask if agg.func is not ast.AggregateFunction.STRING_AGG
                 else (lambda x: x))
        return ast.Aggregate(
            agg.func, mask(agg.expr), agg.distinct, agg.param,
            mask2(agg.expr2) if agg.expr2 is not None else None,
            agg.agg_order_by,
        )

    def parse_ordered_set_aggregate(self) -> ast.Expr:
        """PERCENTILE_CONT(f) WITHIN GROUP (ORDER BY expr [ASC|DESC])
        (PG ordered-set aggregate syntax)."""
        func = ast.AggregateFunction[self.advance().value]
        self.expect_op("(")
        if func is ast.AggregateFunction.MODE:
            frac = None  # MODE() takes no direct argument
        else:
            neg = False
            if self.cur.is_op("-"):
                self.advance()
                neg = True
            ft = self.cur
            if ft.kind != "NUMBER":
                raise ParseError(
                    f"{func.value} fraction must be a numeric literal, "
                    f"got {ft.value!r}"
                )
            self.advance()
            frac = float(ft.value) * (-1.0 if neg else 1.0)
        self.expect_op(")")
        self.expect_kw("WITHIN")
        self.expect_kw("GROUP")
        self.expect_op("(")
        self.expect_kw("ORDER")
        self.expect_kw("BY")
        expr = self.parse_expr()
        desc = False
        if self.match_kw("ASC"):
            pass
        elif self.match_kw("DESC"):
            desc = True
        self.expect_op(")")
        return ast.Aggregate(func, expr, False, (frac, desc))

    def _interval_qualifier(self) -> str:
        """The SQL standard's unit after an interval's quoted quantity
        (INTERVAL '90' DAY (3)): " <unit>" to append to the quoted text, the
        optional leading-field precision read and dropped; "" without one."""
        t = self.cur
        if t.kind != "IDENT" or t.value.upper() not in _QUALIFIER_UNITS:
            return ""
        self.advance()
        if self.cur.is_op("(") and self.peek().kind == "NUMBER" \
                and self.peek(2).is_op(")"):
            self.advance()
            self.advance()
            self.advance()
        return " " + t.value.lower()

    def parse_scalar_function(self) -> ast.Expr:
        name = self.advance().value
        if name.startswith("JSONB_"):  # jsonb_* are aliases of json_* here
            name = "JSON_" + name[len("JSONB_"):]
        func = ast.ScalarFunction[name]
        self.expect_op("(")
        if func is ast.ScalarFunction.EXTRACT:
            # EXTRACT(field FROM expr) — PG special syntax
            ft = self.cur
            if ft.kind not in ("IDENT", "KEYWORD", "STRING"):
                raise ParseError(f"bad EXTRACT field {ft.value!r}")
            self.advance()
            self.expect_kw("FROM")
            inner = self.parse_expr()
            self.expect_op(")")
            return ast.ScalarFunctionCall(
                func, (ast.StringLit(ft.value.lower()), inner)
            )
        args: List[ast.Expr] = []
        if not self.cur.is_op(")"):
            args.append(self.parse_expr())
            if func is ast.ScalarFunction.SUBSTRING and self.match_kw("FROM"):
                # the standard's SUBSTRING(expr FROM start [FOR length])
                args.append(self.parse_expr())
                if self.cur.kind == "IDENT" and self.cur.value.upper() == "FOR":
                    self.advance()
                    args.append(self.parse_expr())
            while self.match_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        return ast.ScalarFunctionCall(func, tuple(args))

    def parse_window_function(self) -> ast.Expr:
        func = ast.WindowFunctionType[self.advance().value]
        self.expect_op("(")
        args: List[ast.Expr] = []
        if not self.cur.is_op(")"):
            args.append(self.parse_expr())
            while self.match_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        self.expect_kw("OVER")
        over = self.parse_window_spec()
        return ast.WindowFunction(func, tuple(args), over)

    def parse_window_spec(self) -> ast.WindowSpec:
        if self.cur.kind == "IDENT":
            # OVER name — resolved against the WINDOW clause at the end of
            # the SELECT (the clause appears after the projection in SQL)
            return ast.WindowSpec(ref=self.advance().value)
        self.expect_op("(")
        partition_by: List[ast.Expr] = []
        order_by: List[ast.OrderByExpr] = []
        frame = None
        if self.match_kw("PARTITION"):
            self.expect_kw("BY")
            partition_by.append(self.parse_expr())
            while self.match_op(","):
                partition_by.append(self.parse_expr())
        if self.cur.is_kw("ORDER"):
            self.advance()
            self.expect_kw("BY")
            order_by.append(self.parse_order_by_expr())
            while self.match_op(","):
                order_by.append(self.parse_order_by_expr())
        if self.cur.is_kw("ROWS", "RANGE"):
            frame = self.parse_window_frame()
        self.expect_op(")")
        return ast.WindowSpec(tuple(partition_by), tuple(order_by), frame)

    def parse_window_frame(self) -> ast.WindowFrame:
        """ROWS/RANGE [BETWEEN] bound [AND bound] (reference parser.rs:1195+)."""
        mode = (
            ast.WindowFrameMode.ROWS
            if self.advance().value == "ROWS"
            else ast.WindowFrameMode.RANGE
        )
        has_between = self.match_kw("BETWEEN")
        start = self.parse_frame_bound()
        end = None
        if has_between:
            self.expect_kw("AND")
            end = self.parse_frame_bound()
        return ast.WindowFrame(mode, start, end)

    def parse_frame_bound(self) -> ast.WindowFrameBound:
        if self.match_kw("CURRENT"):
            self.expect_kw("ROW")
            return ast.WindowFrameBound("CURRENT")
        if self.match_kw("UNBOUNDED"):
            if self.match_kw("PRECEDING"):
                return ast.WindowFrameBound("PRECEDING", None)
            self.expect_kw("FOLLOWING")
            return ast.WindowFrameBound("FOLLOWING", None)
        n = self._parse_usize()
        if self.match_kw("PRECEDING"):
            return ast.WindowFrameBound("PRECEDING", n)
        self.expect_kw("FOLLOWING")
        return ast.WindowFrameBound("FOLLOWING", n)

    # ---- types ---------------------------------------------------------
    def parse_data_type(self) -> DataType:
        """Type-name mapping per reference parser.rs:157-230."""
        t = self.cur
        name = t.value.upper()
        if t.kind not in ("KEYWORD", "IDENT"):
            raise ParseError(f"expected data type, found {t.value!r}")
        self.advance()
        base: DataType
        if name in ("INT", "INTEGER", "BIGINT", "INT8", "SERIAL"):
            base = DataType.int64()
        elif name in ("SMALLINT", "INT2"):
            base = DataType.int16()
        elif name == "INT4":
            base = DataType.int32()
        elif name == "TINYINT":
            base = DataType.int8()
        elif name in ("FLOAT", "DOUBLE", "REAL", "FLOAT8"):
            if name == "DOUBLE":
                self.match_kw("PRECISION")
            base = DataType.float64()
        elif name == "FLOAT4":
            base = DataType.float32()
        elif name in ("DECIMAL", "NUMERIC"):
            p, s = 38, 9  # PG-ish default, matches reference parser.rs:184
            if self.match_op("("):
                p = self._parse_usize()
                s = self._parse_usize() if self.match_op(",") else 0
                self.expect_op(")")
            base = DataType.decimal128(p, s)
        elif name in ("VARCHAR", "CHAR", "TEXT", "STRING"):
            if self.match_op("("):
                self._parse_usize()
                self.expect_op(")")
            base = DataType.utf8()
        elif name in ("BOOLEAN", "BOOL"):
            base = DataType.boolean()
        elif name == "DATE":
            base = DataType.date32()
        elif name in ("TIMESTAMP", "DATETIME", "TIMESTAMPTZ"):
            base = DataType.timestamp()
        elif name == "UUID":
            base = DataType(TypeKind.UUID)
        elif name in ("JSON", "JSONB"):
            base = DataType(TypeKind.JSON)
        elif name == "INTERVAL":
            base = DataType(TypeKind.INTERVAL)
        elif name == "POINT":
            base = DataType(TypeKind.POINT)
        elif name == "TSVECTOR":
            base = DataType(TypeKind.TSVECTOR)
        elif name == "TSQUERY":
            base = DataType(TypeKind.TSQUERY)
        else:
            raise ParseError(f"unknown data type: {name}")
        # arrays: TYPE[]
        while self.cur.is_op("[") and self.peek().is_op("]"):
            self.advance()
            self.advance()
            base = DataType.list_(base)
        return base


def parse_sql(sql: str) -> ast.Statement:
    """Parse a single SQL statement."""
    return Parser(sql).parse()


def parse_many(sql: str) -> List[ast.Statement]:
    """Parse a semicolon-separated script."""
    return Parser(sql).parse_many()
