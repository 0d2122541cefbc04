"""SQL lexer.

Parity surface: reference crates/query-parser/src/lexer.rs:4-442 — ~100
case-insensitive keywords, operators including the full-text `@@`, single-
quoted strings with '' escape, numbers, identifiers (optionally "quoted").

Implementation is a single compiled regex alternation (idiomatic Python),
not a char scanner.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

from query_engine_tpu_torch.core.errors import ParseError

# Keywords recognized by the reference lexer (lexer.rs token enum) plus the
# comparison-adjacent keywords its grammar reserves (LIKE/BETWEEN/IS) and a
# few standard ones needed by real PG clients (CASE/WHEN/THEN/ELSE/END, CAST).
KEYWORDS = {
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "ORDER", "BY", "HAVING",
    "LIMIT", "OFFSET", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS",
    "OUTER", "ON", "AS", "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE", "ILIKE",
    "IS", "NULL", "ASC", "DESC", "COUNT", "SUM", "AVG", "MIN", "MAX", "WITH",
    "VARIANCE", "VAR_POP", "VAR_SAMP", "STDDEV", "STDDEV_POP", "STDDEV_SAMP",
    "MEDIAN", "PERCENTILE_CONT", "PERCENTILE_DISC", "MODE", "WITHIN",
    "COVAR_POP", "COVAR_SAMP", "CORR", "REGR_SLOPE", "REGR_INTERCEPT",
    "REGR_R2", "REGR_AVGX", "REGR_AVGY", "REGR_COUNT", "REGR_SXX",
    "REGR_SYY", "REGR_SXY", "FILTER", "BOOL_AND", "BOOL_OR", "EVERY", "STRING_AGG", "ARRAY_AGG",
    "RECURSIVE", "EXISTS", "OVER", "PARTITION", "ROWS", "RANGE", "UNBOUNDED",
    "PRECEDING", "FOLLOWING", "CURRENT", "ROW",
    "ROW_NUMBER", "RANK", "DENSE_RANK", "NTILE", "LAG", "LEAD",
    "FIRST_VALUE", "LAST_VALUE", "PERCENT_RANK", "CUME_DIST", "NTH_VALUE",
    "UPPER", "LOWER", "LENGTH", "CONCAT", "SUBSTRING", "TRIM", "REPLACE",
    "ABS", "CEIL", "FLOOR", "ROUND", "SQRT", "POWER", "COALESCE", "NULLIF",
    "EXP", "LN", "LOG", "LOG10", "SIGN", "MOD", "PI", "SIN", "COS", "TAN",
    "ASIN", "ACOS", "ATAN", "ATAN2", "DEGREES", "RADIANS", "TRUNC",
    "GREATEST", "LEAST", "LPAD", "RPAD", "REVERSE", "INITCAP", "SPLIT_PART",
    "REPEAT", "LTRIM", "RTRIM", "STRPOS", "STARTS_WITH",
    "SIMILAR", "REGEXP_REPLACE", "REGEXP_LIKE", "REGEXP_SUBSTR",
    "REGEXP_COUNT", "STRING_TO_ARRAY", "ARRAY_TO_STRING", "ARRAY_LENGTH",
    "JSON_EXTRACT_PATH", "JSON_EXTRACT_PATH_TEXT", "JSONB_EXTRACT_PATH",
    "JSONB_EXTRACT_PATH_TEXT", "JSON_ARRAY_LENGTH", "JSON_TYPEOF",
    "JSONB_ARRAY_LENGTH", "JSONB_TYPEOF",
    "CREATE", "DROP", "INDEX", "UNIQUE", "USING", "IF", "TABLE",
    "INSERT", "INTO", "VALUES", "UPDATE", "SET", "DELETE", "RETURNING",
    "TRUE", "FALSE", "BTREE", "HASH", "CONFLICT", "DO", "NOTHING",
    "UNION", "ALL", "ANY", "SOME", "TO_TSVECTOR", "TO_TSQUERY", "CAST",
    "CURRENT_DATE", "CURRENT_TIMESTAMP", "NOW",
    "EXTRACT", "DATE_TRUNC", "ROLLUP", "CUBE", "GROUPING", "SETS",
    "CASE", "WHEN", "THEN", "ELSE", "END",
    "INTERSECT", "EXCEPT",
    # type names (parsed as keywords for CAST/DDL)
    "INT", "INTEGER", "BIGINT", "SMALLINT", "TINYINT", "FLOAT", "REAL",
    "DOUBLE", "PRECISION", "TEXT", "VARCHAR", "CHAR", "BOOLEAN", "BOOL",
    "DATE", "TIMESTAMP", "TIME", "DECIMAL", "NUMERIC", "UUID", "JSON",
    "JSONB", "INTERVAL", "SERIAL",
}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|\d+([eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<param>\$\d+)
  | (?P<op>@@|<>|!=|<=|>=|\|\||::|!~\*|!~|~\*|~|->>|->|\#>>|\#>|[+\-*/%(),.;=<>\[\]])
    """,
    re.VERBOSE | re.DOTALL,
)


@dataclass(frozen=True)
class Token:
    """kind: KEYWORD | IDENT | NUMBER | STRING | PARAM | OP | EOF."""

    kind: str
    value: str
    pos: int = 0

    def is_kw(self, *kws: str) -> bool:
        return self.kind == "KEYWORD" and self.value in kws

    def is_op(self, *ops: str) -> bool:
        return self.kind == "OP" and self.value in ops

    def __repr__(self) -> str:
        return f"{self.kind}({self.value})"


EOF = Token("EOF", "")


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise ParseError(f"unexpected character {sql[pos]!r} at position {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        if m.lastgroup == "num":
            tokens.append(Token("NUMBER", text, m.start()))
        elif m.lastgroup == "str":
            tokens.append(Token("STRING", text[1:-1].replace("''", "'"), m.start()))
        elif m.lastgroup == "qident":
            tokens.append(Token("IDENT", text[1:-1].replace('""', '"'), m.start()))
        elif m.lastgroup == "ident":
            up = text.upper()
            if up in KEYWORDS:
                tokens.append(Token("KEYWORD", up, m.start()))
            else:
                tokens.append(Token("IDENT", text, m.start()))
        elif m.lastgroup == "param":
            tokens.append(Token("PARAM", text, m.start()))
        else:
            tokens.append(Token("OP", text, m.start()))
    tokens.append(Token("EOF", "", n))
    return tokens
