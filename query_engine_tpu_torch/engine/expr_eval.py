"""Vectorized expression evaluation over a ColumnBatch.

The counterpart of `query_engine_tpu.engine.expr_eval`, with the JAX
package's semantics: column references, literals, comparisons (a
DATE/TIMESTAMP against a string literal parses the literal), + - * / %,
decimal arithmetic at PostgreSQL's scales, AND/OR/NOT, unary minus, IS [NOT]
NULL, INTERVAL arithmetic, CASTs, CASE, [NOT] IN (list), [NOT] [I]LIKE, the
regex operators ~ ~* !~ !~* and [NOT] SIMILAR TO, ||, the JSON operators
-> ->> #> #>>, @@, the scalar functions (math, strings, regexes, dates, JSON,
text search, COALESCE/NULLIF/GREATEST/LEAST), UDF calls, and the subquery
forms: scalar, [NOT] IN, [NOT] EXISTS, ANY/ALL, and the planner's
decorrelated lookups, and STRING_TO_ARRAY, ARRAY_TO_STRING and
ARRAY_LENGTH, which make or read LIST columns (a dictionary of Python
lists, as ARRAY_AGG makes them).

A subquery's plan runs through `subquery_exec` (the executor's `execute`),
once per evaluation; inside a compiled program body the pipeline has run it
beforehand and hands its result batch in through `_subplans`, so a program
never executes a plan.

Parity surface: reference crates/query-executor/src/operators.rs:13-848 —
arithmetic with per-type dispatch (:382-507), comparisons with numeric
coercion (:509-538,616-675), and/or/not (:539-570), `@@` full-text match
(:571-611), literal broadcast (:322-347), scalar functions (:64-319).

Every result is (data plane, validity plane, optional host dictionary) on
the batch's device. Numeric and date work is torch ops on the device;
string transforms run once per *dictionary value* on the host and reach the
rows through one gather by code (`builds_host_table` names the expressions
that build such a table). Strings compare through a merged sorted
dictionary, so code order is string order.

Null semantics: SQL three-valued logic. Comparisons with NULL are NULL;
AND/OR follow Kleene logic; predicates treat NULL as false at filter time.
"""

from __future__ import annotations

import datetime
import json as _json
import math
import re
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

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


def _dict_map_host(v: Val, fn, key=None, out_dtype: DataType = None) -> Val:
    """A host string function applied once per dictionary value (kept on
    the dictionary under `key`, when given); the rows' codes are remapped
    into the (sorted) dictionary of the results by one gather on the
    device."""
    d = v.dictionary or Dictionary.empty()
    new_dict, remap = d.map_values(fn, key)
    return Val(_code_table(remap, v), v.validity, out_dtype or v.dtype,
               new_dict)


def _dict_map_host_nullable(v: Val, fn, out_dtype: DataType = None) -> Val:
    """Like _dict_map_host, but fn may return None: the row goes NULL (JSON
    extraction of a missing field, a malformed document, ...)."""
    d = v.dictionary or Dictionary.empty()
    outs = [fn(x) for x in d.values]
    null = np.asarray([o is None for o in outs], dtype=bool)
    new_dict, codes = Dictionary.from_values(
        ["" if o is None else o for o in outs])
    return Val(_code_table(codes, v), v.validity & ~_code_table(null, v),
               out_dtype or v.dtype, new_dict)


def _all_null_val(capacity: int, dtype: DataType, device) -> Val:
    """All-NULL column of the given type (strict functions over a NULL
    input)."""
    if dtype.is_dictionary or dtype.kind is TypeKind.UTF8:
        d, _ = Dictionary.from_values([""])
        return Val(torch.zeros(capacity, dtype=torch.int32, device=device),
                   torch.zeros(capacity, dtype=torch.bool, device=device),
                   DataType.utf8(), d)
    return Val(torch.zeros(capacity, dtype=torch.int64, device=device),
               torch.zeros(capacity, dtype=torch.bool, device=device), dtype)


def exact_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c correctly rounded on every device. On CUDA torch divides by a
    Python number as a multiplication by its reciprocal, which can miss the
    last bit (ROUND(-1.375, 2) would give -1.3800000000000001); a divisor
    on the device divides."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign's values: NaN stays NaN and a zero keeps its sign, where
    torch.sign gives +0 for both."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


# ---- JSON (PostgreSQL -> / ->> / #> / #>> over one document) ----------------

def static_json_key(node):
    """Literal (or negated numeric literal) key of a JSON operator, else
    None."""
    if isinstance(node, lp.Literal):
        return node.value.value
    if isinstance(node, lp.UnaryExpr) and node.op is lp.UnOp.NEG and \
            isinstance(node.expr, lp.Literal) and \
            isinstance(node.expr.value.value, (int, float)):
        return -node.expr.value.value
    return None


_JSON_MISSING = object()


def _json_step(doc, key):
    if isinstance(doc, dict):
        return doc.get(str(key), _JSON_MISSING)
    if isinstance(doc, list):
        try:
            i = int(key)
        except (TypeError, ValueError):
            return _JSON_MISSING
        if -len(doc) <= i < len(doc):
            return doc[i]  # negative indexes wrap from the end (PG)
        return _JSON_MISSING
    return _JSON_MISSING


def _json_extract(s: str, keys, as_text: bool):
    """The value at `keys` in document `s`: its JSON text, or with
    `as_text` a string unquoted and a JSON null as SQL NULL. A malformed
    document gives NULL (PostgreSQL raises; NULL keeps the vectorized path
    total, as division by zero does)."""
    try:
        doc = _json.loads(s)
    except Exception:  # noqa: BLE001
        return None
    for k in keys:
        doc = _json_step(doc, k)
        if doc is _JSON_MISSING:
            return None
    if as_text:
        if doc is None:
            return None
        if isinstance(doc, str):
            return doc
        if isinstance(doc, bool):
            return "true" if doc else "false"
    return _json.dumps(doc)


def _json_array_length(s: str):
    try:
        doc = _json.loads(s)
    except Exception:  # noqa: BLE001
        return None
    return len(doc) if isinstance(doc, list) else None  # PG errors -> NULL


def _json_typeof(s: str):
    try:
        doc = _json.loads(s)
    except Exception:  # noqa: BLE001
        return None
    if doc is None:
        return "null"
    if isinstance(doc, bool):
        return "boolean"
    if isinstance(doc, (int, float)):
        return "number"
    if isinstance(doc, str):
        return "string"
    return "array" if isinstance(doc, list) else "object"


# ---- text search (reference operators.rs:261-315, 571-611) ------------------

def _tokenize_tsvector(s: str) -> str:
    """to_tsvector: split on non-alphanumerics, sort (before lowercasing),
    drop consecutive duplicates, lowercase, join with spaces."""
    tokens = sorted(w for w in re.split(r"[^0-9A-Za-z]+", s) if w)
    dedup = []
    for t in tokens:
        if not dedup or dedup[-1] != t:
            dedup.append(t)
    return " ".join(t.lower() for t in dedup)


def _normalize_tsquery(s: str) -> str:
    return " ".join(t if t in ("&", "|", "!") else t.lower()
                    for t in s.split())


def _ts_match(doc: str, query: str) -> bool:
    """@@: every term of the query that is not an operator and not
    !-prefixed appears among the document's whitespace tokens."""
    doc_tokens = set(doc.split())
    terms = [t for t in query.split()
             if t not in ("&", "|") and not t.startswith("!")]
    return all(t in doc_tokens for t in terms)


# ---- patterns ---------------------------------------------------------------

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


def _similar_to_regex(pattern: str) -> str:
    """SQL SIMILAR TO pattern -> Python regex source. It keeps the regex
    metacharacters | * + ? {m,n} ( ) [ ... ], adds the % and _ wildcards,
    and takes . ^ $ literally; % and _ inside a bracket class stay literal
    (PostgreSQL 9.7.2)."""
    out = []
    i, n = 0, len(pattern)
    in_class = False
    while i < n:
        ch = pattern[i]
        if in_class:
            out.append(ch)
            if ch == "\\" and i + 1 < n:
                out.append(pattern[i + 1])
                i += 1
            elif ch == "]":
                in_class = False
        elif ch == "\\" and i + 1 < n:
            out.append(re.escape(pattern[i + 1]))  # an escaped literal
            i += 1
        elif ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        elif ch in ".^$":
            out.append("\\" + ch)
        elif ch == "[":
            out.append(ch)
            in_class = True
        else:
            out.append(ch)
        i += 1
    return "".join(out)


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


def _temporal_join(days: torch.Tensor, tod: torch.Tensor, like: Val) -> Val:
    """(days, microseconds into the day) back into `like`'s lane."""
    k = like.dtype.kind
    if k is TypeKind.DATE32:
        return days.to(torch.int32)
    if k is TypeKind.DATE64:
        return days * 86_400_000 + tod // 1000
    return days * _US_DAY + tod


# ---- decimals: an int64 lane scaled by 10^scale -----------------------------

def _dec_scale(t: DataType) -> int:
    return t.params[1] if t.params else 0


def _descale(v: Val) -> Val:
    """Decimal scaled-int plane -> float64 value plane."""
    return Val(exact_div(v.data.to(torch.float64), 10.0 ** _dec_scale(v.dtype)),
               v.validity, DataType.float64())


def _coerce_decimals(op, l: Val, r: Val) -> Tuple[Val, Val]:
    """Scale-aware decimal arithmetic and comparison. Division or a float
    operand descales to float64; otherwise both sides become int64 planes
    at the result's scale (the larger for + - % and comparisons; untouched
    for *, whose scales add), so the integer path computes the scaled
    plane."""
    l_dec = l.dtype.kind is TypeKind.DECIMAL128
    r_dec = r.dtype.kind is TypeKind.DECIMAL128
    if not (l_dec or r_dec):
        return l, r
    if op is lp.BinOp.DIV or l.dtype.is_float or r.dtype.is_float:
        return (_descale(l) if l_dec else l), (_descale(r) if r_dec else r)
    s1 = _dec_scale(l.dtype) if l_dec else 0
    s2 = _dec_scale(r.dtype) if r_dec else 0
    if op is lp.BinOp.MUL:
        tgt1, tgt2 = s1, s2
    else:
        tgt1 = tgt2 = max(s1, s2)

    def rescale(v, frm, to):
        d = v.data.to(torch.int64)
        if to > frm:
            d = d * (10 ** (to - frm))
        return Val(d, v.validity, DataType.int64())

    return rescale(l, s1, tgt1), rescale(r, s2, tgt2)


_LIKE_OPS = {lp.BinOp.LIKE, lp.BinOp.NOT_LIKE, lp.BinOp.ILIKE,
             lp.BinOp.NOT_ILIKE}
_PATTERN_OPS = _LIKE_OPS | lp._REGEX_OPS


# the type of a program input literal, by the dtype of its tensor
_DYN_TYPES = {
    torch.bool: DataType.boolean,
    torch.int64: DataType.int64,
    torch.float64: DataType.float64,
}

_ARITH = {lp.BinOp.ADD, lp.BinOp.SUB, lp.BinOp.MUL, lp.BinOp.DIV,
          lp.BinOp.MOD}
_CMP = {
    lp.BinOp.EQ: torch.eq,
    lp.BinOp.NEQ: torch.ne,
    lp.BinOp.LT: torch.lt,
    lp.BinOp.LTE: torch.le,
    lp.BinOp.GT: torch.gt,
    lp.BinOp.GTE: torch.ge,
}

_F = lp.ScalarFn
# functions over LIST values (they go with ARRAY_AGG and UNNEST); kept out
# of compiled programs (pipeline._expr_traceable)
LIST_FNS = {_F.STRING_TO_ARRAY, _F.ARRAY_TO_STRING, _F.ARRAY_LENGTH}
# functions that run once per dictionary value on the host (their first
# argument's dictionary), or build one table per row (CONCAT)
_HOST_FNS = {
    _F.UPPER, _F.LOWER, _F.TRIM, _F.LENGTH, _F.REPLACE, _F.SUBSTRING,
    _F.CONCAT, _F.LEFT, _F.RIGHT, _F.LPAD, _F.RPAD, _F.REVERSE, _F.INITCAP,
    _F.SPLIT_PART, _F.REPEAT, _F.LTRIM, _F.RTRIM, _F.STRPOS, _F.STARTS_WITH,
    _F.REGEXP_REPLACE, _F.REGEXP_LIKE, _F.REGEXP_SUBSTR, _F.REGEXP_COUNT,
    _F.JSON_EXTRACT_PATH, _F.JSON_EXTRACT_PATH_TEXT, _F.JSON_ARRAY_LENGTH,
    _F.JSON_TYPEOF, _F.TO_TSVECTOR, _F.TO_TSQUERY,
} | LIST_FNS
# functions that merge their arguments' dictionaries when one is a string
_MERGING_FNS = {_F.COALESCE, _F.NULLIF, _F.GREATEST, _F.LEAST}


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
    the device: the merged-dictionary code remap of a string comparison,
    string IN, or a COALESCE/NULLIF/GREATEST/LEAST over strings
    (`unify_dicts`); the per-value match table of LIKE, the regex operators,
    SIMILAR TO and @@; a CASE with string results (`_eval_case`); the
    per-value maps and lookups of the string, regex, JSON and text-search
    functions and of the JSON operators; CONCAT and || (one string per
    row); a cast between strings and other types that is not a date
    literal (`_eval_cast`); a UDF call; and the code remap of an IN or
    ANY/ALL subquery or a correlated lookup whose keys are strings. A date
    literal (`temporal_literal`) is not among them."""
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
        elif isinstance(x, lp.ScalarFnExpr):
            if x.func in _HOST_FNS or (x.func in _MERGING_FNS and any(
                    a.dtype.is_dictionary for a in x.args)):
                found.append(x)
        elif isinstance(x, lp.UdfExpr):
            found.append(x)
        elif isinstance(x, lp.BinaryExpr):
            if x.op is lp.BinOp.CONCAT or (
                    (x.left.dtype.is_dictionary or x.right.dtype.is_dictionary)
                    and temporal_literal(x) is None):
                found.append(x)
        elif isinstance(x, lp.InListExpr):
            if x.expr.dtype.is_dictionary or any(
                    i.dtype.is_dictionary for i in x.items):
                found.append(x)
        elif isinstance(x, lp.CaseExpr):
            if x.dtype.is_dictionary:
                found.append(x)
        elif isinstance(x, lp.CastExpr):
            if x.target.is_dictionary != x.expr.dtype.is_dictionary \
                    and x.expr.dtype.kind is not TypeKind.NULL \
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
    np_t = np.dtype(t.device_dtype)
    if np_t in (np.uint16, np.uint32, np.uint64):
        return torch.int64
    return torch.from_numpy(np.zeros(0, dtype=np_t)).dtype


def _f64(v: Val):
    """(float64 values, validity) of a numeric or decimal value."""
    x = _descale(v) if v.dtype.kind is TypeKind.DECIMAL128 else v
    return x.data.to(torch.float64), x.validity


class Evaluator:
    """Evaluates LogicalExprs over a batch; literals are made on `device`.
    `subquery_exec` (physical plan -> ColumnBatch) runs a subquery's plan;
    the executor supplies its own `execute`. `udfs` is the Session's
    UdfRegistry."""

    def __init__(self, device, udfs=None, subquery_exec=None):
        # what a program body sets is per thread: a mesh program runs one
        # body per shard, each in a thread of its own, on its shard's device
        self._tls = threading.local()
        self._device = torch.device(device)
        self.udfs = udfs
        self.subquery_exec = subquery_exec
        # per query: the rank match of an outer batch's keys against a
        # shared (multiply referenced) subplan's keys, which several
        # correlated lookups rooted at one shared aggregate repeat (Q21's
        # EXISTS and MIN/MAX bounds); the Session clears it around a query
        self._corr_match_memo = {}

    @property
    def device(self) -> torch.device:
        """Where literals are made: the shard's device inside a mesh
        program's body, else the evaluator's."""
        return getattr(self._tls, "device", None) or self._device

    @property
    def _shard_device(self):
        return getattr(self._tls, "device", None)

    @_shard_device.setter
    def _shard_device(self, value) -> None:
        self._tls.device = value

    @property
    def _dyn_literals(self):
        """While the compiled pipeline runs a program body: id(Literal) ->
        0-d tensor holding its value, so one program serves every value of
        the literal (engine/pipeline.py)."""
        return getattr(self._tls, "dyn_literals", None)

    @_dyn_literals.setter
    def _dyn_literals(self, value) -> None:
        self._tls.dyn_literals = value

    @property
    def _subplans(self):
        """While the compiled pipeline runs a program body: id(subplan) ->
        the batch the pipeline materialized for it before the program
        ran."""
        return getattr(self._tls, "subplans", None)

    @_subplans.setter
    def _subplans(self, value) -> None:
        self._tls.subplans = value

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
            return self._eval_scalar_fn(e, batch)
        if isinstance(e, lp.UdfExpr):
            return self._eval_udf(e, batch)
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
        raise ExecutionError(f"cannot evaluate {type(e).__name__}")

    def eval_agg_arg(self, agg: lp.AggregateExpr, batch: ColumnBatch) -> Val:
        """An aggregate's argument; AVG of a DECIMAL averages its values,
        not its scaled integers."""
        av = self.eval(agg.expr, batch)
        if agg.func is lp.AggFunc.AVG and av.dtype.kind is TypeKind.DECIMAL128:
            return _descale(av)
        return av

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
        if op in (lp.BinOp.ADD, lp.BinOp.SUB) and (
                isinstance(e.left, lp.IntervalLiteral)
                or isinstance(e.right, lp.IntervalLiteral)):
            return self._eval_temporal_interval(e, batch)

        l = self.eval(e.left, batch)
        r = self.eval(e.right, batch)
        if op is lp.BinOp.TS_MATCH:
            return self._eval_ts_match(l, r)
        if op in _PATTERN_OPS:
            return self._eval_like(op, l, r)
        if op is lp.BinOp.CONCAT:
            return self._eval_concat([l, r], batch)
        if op in lp._JSON_OPS:
            return self._eval_json_get(e, l, op)

        valid = l.validity & r.validity
        # temporal column vs string literal: parse the literal as a date or
        # timestamp, so WHERE d > '2024-01-01' compares days with days
        l, r = _coerce_temporal_literal(l, r)
        if (l.dtype.is_temporal and r.dictionary is not None) or (
                r.dtype.is_temporal and l.dictionary is not None):
            raise ExecutionError(
                f"cannot compare a {l.dtype if l.dtype.is_temporal else r.dtype}"
                f" value with a string that is not a date: {e.name()}")
        l, r = _coerce_decimals(op, l, r)
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
        elif op is lp.BinOp.MOD:
            # a zero divisor gives NULL; the floored modulo (torch's and
            # jnp's %), then moved toward zero: SQL's sign follows the
            # dividend
            zero = rd == 0
            safe_r = torch.where(zero, torch.ones_like(rd), rd)
            data = torch.remainder(ld, safe_r)
            data = torch.where((data != 0) & (_sign(data) != _sign(ld)),
                               data - safe_r, data)
            valid = valid & ~zero
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

    def _eval_temporal_interval(self, e: lp.BinaryExpr, batch) -> Val:
        """date/timestamp +/- INTERVAL literal. Months are calendar months
        that clamp the day of the month (Jan 31 + 1 month = Feb 28/29, as in
        PostgreSQL); days and sub-day microseconds add directly."""
        if isinstance(e.right, lp.IntervalLiteral):
            tv = self.eval(e.left, batch)
            iv = e.right
            sign = 1 if e.op is lp.BinOp.ADD else -1
        else:
            if e.op is lp.BinOp.SUB:
                raise ExecutionError(
                    "cannot subtract a timestamp from an interval")
            tv = self.eval(e.right, batch)
            iv = e.left
            sign = 1
        if not tv.dtype.is_temporal:
            raise ExecutionError(
                f"interval arithmetic needs a date/timestamp, got {tv.dtype}"
            )
        if tv.dtype.kind is TypeKind.DATE32 and iv.micros:
            raise ExecutionError(
                "date +/- sub-day interval: cast the date to TIMESTAMP first"
            )
        days, tod = _temporal_split(tv)
        m, d, us = iv.months * sign, iv.days * sign, iv.micros * sign
        if m:
            y, mo, dd = _civil_from_days(days)
            t = y * 12 + (mo - 1) + m
            y2 = t // 12
            mo2 = t % 12 + 1
            nxt_y = torch.where(mo2 == 12, y2 + 1, y2)
            nxt_m = torch.where(mo2 == 12, torch.ones_like(mo2), mo2 + 1)
            one = torch.ones_like(y2)
            dim = _days_from_civil(nxt_y, nxt_m, one) - _days_from_civil(
                y2, mo2, one)
            days = _days_from_civil(y2, mo2, torch.minimum(dd, dim))
        days = days + d
        tod = tod + us
        extra = tod // _US_DAY
        days = days + extra
        tod = tod - extra * _US_DAY
        return Val(_temporal_join(days, tod, tv), tv.validity, tv.dtype)

    def _eval_json_get(self, e: lp.BinaryExpr, l: Val, op) -> Val:
        """-> / ->> / #> / #>>: one json.loads per distinct document, one
        gather per row. The key must be a literal, so the extraction table
        depends on the dictionary alone."""
        key = static_json_key(e.right)
        if key is None:
            raise ExecutionError(
                f"the right side of {op.value} must be a non-null string or "
                "integer literal")
        if l.dictionary is None:
            raise ExecutionError(
                f"operator {op.value} requires a json (string) left operand")
        if op in (lp.BinOp.JSON_PATH, lp.BinOp.JSON_PATH_TEXT):
            keys = [p.strip().strip('"')
                    for p in str(key).strip().lstrip("{").rstrip("}").split(",")
                    if p.strip() != ""]
        else:
            keys = [key]
        as_text = op in (lp.BinOp.JSON_GET_TEXT, lp.BinOp.JSON_PATH_TEXT)
        return _dict_map_host_nullable(
            l, lambda s: _json_extract(s, keys, as_text), DataType.utf8())

    def _eval_ts_match(self, l: Val, r: Val) -> Val:
        """doc @@ query: one match per document value when the query is one
        value (a literal), else one per row on the host."""
        if l.dictionary is None or r.dictionary is None:
            raise ExecutionError("@@ requires string operands")
        dl, dr = l.dictionary, r.dictionary
        if len(dr) == 1:
            q = dr.values[0]
            table = np.asarray([_ts_match(doc, q) for doc in dl.values],
                               dtype=bool)
            data = _code_table(table, l)
        else:
            docs = dl.decode(l.data.cpu().numpy())
            queries = dr.decode(r.data.cpu().numpy())
            data = to_tensor(np.asarray(
                [_ts_match(d, q) for d, q in zip(docs, queries)], dtype=bool),
                l.data.device)
        return Val(data, l.validity & r.validity, DataType.boolean())

    # ---- LIKE / regex / SIMILAR TO ---------------------------------------
    def _eval_like(self, op: lp.BinOp, l: Val, r: Val) -> Val:
        """[NOT] [I]LIKE, the POSIX operators (~ ~* !~ !~*, an unanchored
        search) and [NOT] SIMILAR TO against a literal pattern: one regex
        match per dictionary value on the host, then a gather by code on the
        device."""
        B = lp.BinOp
        if l.dictionary is None or r.dictionary is None \
                or len(r.dictionary) != 1:
            raise ExecutionError(
                f"{op.value} requires a string column and a literal pattern"
            )
        pat = r.dictionary.values[0]
        ci = op in (B.ILIKE, B.NOT_ILIKE, B.REGEX_IMATCH, B.NOT_REGEX_IMATCH)
        neg = op in (B.NOT_LIKE, B.NOT_ILIKE, B.NOT_REGEX_MATCH,
                     B.NOT_REGEX_IMATCH, B.NOT_SIMILAR_TO)
        flags = re.IGNORECASE if ci else 0
        if op in _LIKE_OPS:
            match = like_to_regex(pat, ci).match
        elif op in (B.SIMILAR_TO, B.NOT_SIMILAR_TO):
            match = re.compile("^(?:" + _similar_to_regex(pat) + ")$",
                               flags).match
        else:
            match = re.compile(pat, flags).search
        table = np.asarray([bool(match(x)) for x in l.dictionary.values],
                           dtype=bool)
        data = _code_table(table, l)
        if neg:
            data = ~data
        return Val(data, l.validity & r.validity, DataType.boolean())

    def _eval_concat(self, vals: List[Val], batch: ColumnBatch) -> Val:
        """String concatenation, one string per row on the host (the
        dictionaries' cross product would explode); NULL when a part is."""
        parts = []
        valid = torch.ones(batch.capacity, dtype=torch.bool,
                           device=self.device)
        for v in vals:
            host = v.data.cpu().numpy()
            if v.dictionary is not None:
                parts.append(v.dictionary.decode(host))
            elif v.data.is_floating_point():
                parts.append(np.asarray([repr(float(x)) for x in host],
                                        dtype=object))
            else:
                parts.append(host.astype(str).astype(object))
            valid = valid & v.validity
        out = parts[0]
        for p in parts[1:]:
            out = np.char.add(out.astype(str), p.astype(str)).astype(object)
        d, codes = Dictionary.from_values(list(out))
        return Val(to_tensor(codes, self.device), valid, DataType.utf8(), d)

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
        if t.is_dictionary:
            if v.dictionary is not None:
                return Val(v.data, v.validity, t, v.dictionary)
            # a number, boolean or date to a string: stringified on the host
            host = v.data.cpu().numpy()
            if v.dtype.is_float:
                strs = [repr(float(x)) for x in host]
            elif v.dtype.kind is TypeKind.BOOLEAN:
                strs = ["true" if x else "false" for x in host]
            else:
                strs = [str(int(x)) for x in host]
            d, codes = Dictionary.from_values(strs)
            return Val(to_tensor(codes, self.device), v.validity, t, d)
        if v.dictionary is not None:
            if t.is_temporal:
                # string -> date/timestamp: one ISO parse per dictionary
                # value; a string that does not parse gives NULL
                sentinel = np.iinfo(np.int64).min

                def parse_t(s):
                    p = parse_temporal(s, t.kind)
                    return sentinel if p is None else p

                tv = _dict_lookup_host(v, parse_t, np.int64, t)
                bad = tv.data == sentinel
                return Val(tv.data.to(_torch_dtype(t)), tv.validity & ~bad, t)

            # string -> number: one parse per dictionary value; a string
            # that does not parse gives NULL
            def parse(s):
                try:
                    return float(s)
                except ValueError:
                    return np.nan

            fv = _dict_lookup_host(v, parse, np.float64, DataType.float64())
            bad = torch.isnan(fv.data)
            if t.is_float:
                return Val(fv.data, fv.validity & ~bad, t)
            return Val(fv.data.to(torch.int64), fv.validity & ~bad, t)
        if t.kind is TypeKind.BOOLEAN:
            return Val(v.data.to(torch.bool), v.validity, t)
        if t.kind is TypeKind.DECIMAL128 and t.params:
            src = (_descale(v).data if v.dtype.kind is TypeKind.DECIMAL128
                   else v.data.to(torch.float64))
            # the reference's jnp.round: half to even
            scaled = torch.round(src * (10 ** t.params[1]))
            return Val(scaled.to(torch.int64), v.validity, t)
        if v.dtype.kind is TypeKind.DECIMAL128:
            f = _descale(v)
            if t.is_float:
                return Val(f.data.to(_torch_dtype(t)), v.validity, t)
            # to an integer: half away from zero, as ROUND
            d = _sign(f.data) * torch.floor(torch.abs(f.data) + 0.5)
            return Val(d.to(_torch_dtype(t)), v.validity, t)
        return Val(v.data.to(_torch_dtype(t)), v.validity, t)

    # ---- scalar functions ----------------------------------------------
    def _eval_scalar_fn(self, e: lp.ScalarFnExpr, batch: ColumnBatch) -> Val:
        f = e.func
        if f is _F.EXTRACT:
            return self._eval_extract(e, batch)
        args = [self.eval(a, batch) for a in e.args]
        if f is _F.UPPER:
            return _dict_map_host(args[0], str.upper, "UPPER")
        if f is _F.LOWER:
            return _dict_map_host(args[0], str.lower, "LOWER")
        if f is _F.TRIM:
            return _dict_map_host(args[0], str.strip, "TRIM")
        if f is _F.LENGTH:
            # the reference's byte length (s.len() in Rust)
            return _dict_lookup_host(
                args[0], lambda s: len(s.encode("utf-8")), np.int64,
                DataType.int64())
        if f is _F.REPLACE:
            frm = self._literal_str(args[1], "REPLACE")
            to = self._literal_str(args[2], "REPLACE")
            return _dict_map_host(args[0], lambda s: s.replace(frm, to),
                                  ("REPLACE", frm, to))
        if f is _F.SUBSTRING:
            start = int(self._static_num(e.args[1], args[1], "SUBSTRING"))
            length = (int(self._static_num(e.args[2], args[2], "SUBSTRING"))
                      if len(args) > 2 else None)
            lo = max(start - 1, 0)  # SQL is 1-based

            def sub(s):
                return s[lo:lo + length] if length is not None else s[lo:]

            return _dict_map_host(args[0], sub, ("SUBSTRING", lo, length))
        if f is _F.CONCAT:
            return self._eval_concat(args, batch)
        if f is _F.ABS:
            v = args[0]
            return Val(torch.abs(v.data), v.validity, v.dtype)
        if f in (_F.CEIL, _F.FLOOR, _F.SQRT):
            x, valid = _f64(args[0])
            fn = {_F.CEIL: torch.ceil, _F.FLOOR: torch.floor,
                  _F.SQRT: torch.sqrt}[f]
            if f is _F.SQRT:
                valid = valid & (x >= 0)
            return Val(fn(x), valid, DataType.float64())
        if f is _F.ROUND:
            x, valid = _f64(args[0])
            # half away from zero (PG/Arrow), not torch.round's half to even
            if len(args) > 1:
                m = 10.0 ** int(self._static_num(e.args[1], args[1], "ROUND"))
                out = exact_div(_sign(x) * torch.floor(torch.abs(x) * m + 0.5),
                                m)
            else:
                out = _sign(x) * torch.floor(torch.abs(x) + 0.5)
            return Val(out, valid, DataType.float64())
        if f is _F.POWER:
            a, b = args
            out = torch.pow(a.data.to(torch.float64), b.data.to(torch.float64))
            return Val(out, a.validity & b.validity, DataType.float64())
        if f is _F.COALESCE:
            return self._eval_coalesce(args)
        if f is _F.NULLIF:
            a, b = args
            if a.dictionary is not None or b.dictionary is not None:
                a2, b2 = unify_dicts(a, b)
                eq = (a2.data == b2.data) & a.validity & b.validity
                return Val(a2.data, a.validity & ~eq, a.dtype, a2.dictionary)
            eq = (a.data == b.data) & a.validity & b.validity
            return Val(a.data, a.validity & ~eq, a.dtype, a.dictionary)
        if f is _F.DATE_TRUNC:
            return self._eval_date_trunc(args)
        if f in (_F.JSON_EXTRACT_PATH, _F.JSON_EXTRACT_PATH_TEXT):
            # the function form of #> / #>>; no path elements = the
            # document reparsed (PG)
            keys = [static_json_key(a) for a in e.args[1:]]
            if any(k is None for k in keys):
                raise ExecutionError(
                    f"{f.value} path elements must be string or integer "
                    "literals")
            if args[0].dtype.kind is TypeKind.NULL:
                return _all_null_val(args[0].capacity, DataType.utf8(),
                                     self.device)
            if args[0].dictionary is None:
                raise ExecutionError(
                    f"{f.value} requires a json (string) first argument")
            as_text = f is _F.JSON_EXTRACT_PATH_TEXT
            return _dict_map_host_nullable(
                args[0], lambda s: _json_extract(s, keys, as_text),
                DataType.utf8())
        if f in (_F.JSON_ARRAY_LENGTH, _F.JSON_TYPEOF):
            v = args[0]
            if v.dtype.kind is TypeKind.NULL:
                # strict functions: NULL input -> NULL output (PG)
                return _all_null_val(
                    v.capacity, DataType.int64() if f is _F.JSON_ARRAY_LENGTH
                    else DataType.utf8(), self.device)
            if v.dictionary is None:
                raise ExecutionError(
                    f"{f.value} requires a json (string) argument")
            if f is _F.JSON_TYPEOF:
                return _dict_map_host_nullable(v, _json_typeof,
                                               DataType.utf8())
            outs = [_json_array_length(x) for x in v.dictionary.values]
            table = np.asarray([0 if o is None else o for o in outs],
                               np.int64)
            null = np.asarray([o is None for o in outs], bool)
            return Val(_code_table(table, v),
                       v.validity & ~_code_table(null, v), DataType.int64())
        if f is _F.TO_TSVECTOR:
            return _dict_map_host(args[0], _tokenize_tsvector, "TO_TSVECTOR",
                                  DataType(TypeKind.TSVECTOR))
        if f is _F.TO_TSQUERY:
            return _dict_map_host(args[0], _normalize_tsquery, "TO_TSQUERY",
                                  DataType(TypeKind.TSQUERY))
        out = self._eval_math_fn(e, f, args)
        if out is None:
            out = self._eval_string_fn(e, f, args)
        if out is not None:
            return out
        raise ExecutionError(f"scalar function {f.value} not implemented")

    # unary math: (torch function, domain-validity function or None)
    _MATH_UNARY = {
        _F.EXP: (torch.exp, None),
        _F.LN: (torch.log, lambda x: x > 0),
        _F.LOG10: (lambda x: exact_div(torch.log(x), math.log(10.0)),
                   lambda x: x > 0),
        _F.SIGN: (_sign, None),
        _F.SIN: (torch.sin, None),
        _F.COS: (torch.cos, None),
        _F.TAN: (torch.tan, None),
        _F.ASIN: (torch.asin, lambda x: torch.abs(x) <= 1),
        _F.ACOS: (torch.acos, lambda x: torch.abs(x) <= 1),
        _F.ATAN: (torch.atan, None),
        _F.DEGREES: (torch.rad2deg, None),
        _F.RADIANS: (torch.deg2rad, None),
    }

    def _eval_math_fn(self, e, f, args) -> Optional[Val]:
        """The math functions, on the device in float64. A value outside a
        function's domain (LN of a non-positive, ASIN outside [-1, 1]) gives
        NULL rather than NaN."""
        if f in self._MATH_UNARY:
            fn, dom = self._MATH_UNARY[f]
            x, ok = _f64(args[0])
            if dom is not None:
                ok = ok & dom(x)
            return Val(fn(x), ok, DataType.float64())
        if f is _F.LOG:
            if len(args) == 1:  # PG: LOG(x) = log10
                x, ok = _f64(args[0])
                return Val(exact_div(torch.log(x), math.log(10.0)),
                           ok & (x > 0),
                           DataType.float64())
            b, bok = _f64(args[0])
            x, xok = _f64(args[1])
            ok = bok & xok & (x > 0) & (b > 0) & (b != 1.0)
            return Val(torch.log(x) / torch.log(b), ok, DataType.float64())
        if f is _F.ATAN2:
            y, yok = _f64(args[0])
            x, xok = _f64(args[1])
            return Val(torch.atan2(y, x), yok & xok, DataType.float64())
        if f is _F.TRUNC:
            x, ok = _f64(args[0])
            if len(args) > 1:
                m = 10.0 ** int(self._static_num(e.args[1], args[1], "TRUNC"))
                return Val(exact_div(torch.trunc(x * m), m), ok,
                           DataType.float64())
            return Val(torch.trunc(x), ok, DataType.float64())
        if f in (_F.GREATEST, _F.LEAST):
            # PG: a NULL argument is ignored; NULL only when all are NULL
            if any(a.dictionary is not None for a in args):
                raise ExecutionError(f"{f.value} over strings not supported")
            pick_hi = f is _F.GREATEST
            acc, ok = args[0].data, args[0].validity
            for a in args[1:]:
                better = (a.data > acc) if pick_hi else (a.data < acc)
                take = a.validity & (better | ~ok)
                acc = torch.where(take, a.data, acc)
                ok = ok | a.validity
            dt = next((a.dtype for a in args
                       if a.dtype.kind is not TypeKind.NULL), args[0].dtype)
            return Val(acc, ok, dt)
        return None

    def _eval_string_fn(self, e, f, args) -> Optional[Val]:
        """The string functions: once per dictionary value on the host, one
        gather per row on the device."""
        if f in (_F.LEFT, _F.RIGHT):
            # PG: a negative n drops |n| characters from the other end, as
            # Python slicing does (RIGHT(s, 0) is the one special case)
            n = int(self._static_num(e.args[1], args[1], f.value))
            if f is _F.LEFT:
                cut = lambda s: s[:n]  # noqa: E731
            else:
                cut = lambda s: "" if n == 0 else s[-n:]  # noqa: E731
            return _dict_map_host(args[0], cut, (f.value, n))
        if f in (_F.LPAD, _F.RPAD):
            ln = int(self._static_num(e.args[1], args[1], f.value))
            fill = (self._literal_str(args[2], f.value)
                    if len(args) > 2 else " ")
            left = f is _F.LPAD

            def pad(s):
                if len(s) >= ln:
                    return s[:ln]
                if not fill:
                    return s
                need = ln - len(s)
                p = (fill * (need // len(fill) + 1))[:need]
                return p + s if left else s + p

            return _dict_map_host(args[0], pad, (f.value, ln, fill))
        if f is _F.REVERSE:
            return _dict_map_host(args[0], lambda s: s[::-1], "REVERSE")
        if f is _F.INITCAP:
            def initcap(s):
                return re.sub(
                    r"[A-Za-z0-9]+",
                    lambda m: m.group(0)[:1].upper() + m.group(0)[1:].lower(),
                    s)

            return _dict_map_host(args[0], initcap, "INITCAP")
        if f is _F.SPLIT_PART:
            delim = self._literal_str(args[1], "SPLIT_PART")
            n = int(self._static_num(e.args[2], args[2], "SPLIT_PART"))
            if n == 0:
                raise ExecutionError("SPLIT_PART field position must not be 0")

            def part(s):
                parts = s.split(delim) if delim else [s]
                i = n - 1 if n > 0 else len(parts) + n
                return parts[i] if 0 <= i < len(parts) else ""

            return _dict_map_host(args[0], part, ("SPLIT_PART", delim, n))
        if f is _F.REPEAT:
            n = int(self._static_num(e.args[1], args[1], "REPEAT"))
            return _dict_map_host(args[0], lambda s: s * max(n, 0),
                                  ("REPEAT", n))
        if f in (_F.LTRIM, _F.RTRIM):
            chars = (self._literal_str(args[1], f.value)
                     if len(args) > 1 else None)
            fn = str.lstrip if f is _F.LTRIM else str.rstrip
            return _dict_map_host(args[0], lambda s: fn(s, chars),
                                  (f.value, chars))
        if f is _F.STRPOS:
            sub = self._literal_str(args[1], "STRPOS")
            return _dict_lookup_host(args[0], lambda s: s.find(sub) + 1,
                                     np.int64, DataType.int64())
        if f is _F.STARTS_WITH:
            pre = self._literal_str(args[1], "STARTS_WITH")
            return _dict_lookup_host(args[0], lambda s: s.startswith(pre),
                                     np.bool_, DataType.boolean())
        if f in (_F.REGEXP_REPLACE, _F.REGEXP_LIKE, _F.REGEXP_SUBSTR,
                 _F.REGEXP_COUNT):
            return self._eval_regexp_fn(f, args)
        if f in LIST_FNS:
            return self._eval_list_fn(f, args)
        return None

    def _eval_list_fn(self, f, args) -> Val:
        """STRING_TO_ARRAY, ARRAY_TO_STRING and ARRAY_LENGTH. A LIST value
        is a dictionary of Python lists (ARRAY_AGG's result, or the lists
        STRING_TO_ARRAY makes once per string), so each function runs once
        per dictionary value on the host, as the string functions do."""
        if f is _F.STRING_TO_ARRAY:
            delim = self._literal_str(args[1], "STRING_TO_ARRAY")
            return _dict_map_host(
                args[0], lambda s: s.split(delim) if s else [],
                ("STRING_TO_ARRAY", delim), DataType.list_(DataType.utf8()))
        if f is _F.ARRAY_TO_STRING:
            delim = self._literal_str(args[1], "ARRAY_TO_STRING")

            def join_elems(lst):
                if not isinstance(lst, (list, tuple)):
                    return "" if lst is None else str(lst)
                # PG skips NULL elements
                return delim.join(str(x) for x in lst if x is not None)

            return _dict_map_host(args[0], join_elems,
                                  ("ARRAY_TO_STRING", delim), DataType.utf8())
        return _dict_lookup_host(
            args[0],
            lambda lst: len(lst) if isinstance(lst, (list, tuple)) else 1,
            np.int64, DataType.int64())

    def _eval_regexp_fn(self, f, args) -> Val:
        """PostgreSQL's regexp_* functions. The pattern and flags must be
        literals; the regex runs once per distinct dictionary value on the
        host, and each row gets its result by one gather on the device."""
        pat = self._literal_str(args[1], f.value)
        # a trailing flags argument: 'g' replaces all, 'i' folds case
        fi = 3 if f is _F.REGEXP_REPLACE else 2
        flags_s = (self._literal_str(args[fi], f.value)
                   if len(args) > fi else "")
        unknown = set(flags_s) - set("gi")
        if unknown:
            raise ExecutionError(
                f"{f.value}: unsupported regex flag(s) {sorted(unknown)}")
        rx = re.compile(pat, re.IGNORECASE if "i" in flags_s else 0)
        if f is _F.REGEXP_REPLACE:
            repl_raw = self._literal_str(args[2], f.value)
            # PG replacement escapes: \1..\9 group references, \& the whole
            # match, \\ a backslash -> Python re.sub syntax
            repl = re.sub(r"\\&", r"\\g<0>", repl_raw)
            count = 0 if "g" in flags_s else 1
            return _dict_map_host(args[0],
                                  lambda s: rx.sub(repl, s, count=count),
                                  (f.value, pat, flags_s, repl_raw))
        if f is _F.REGEXP_LIKE:
            return _dict_lookup_host(args[0], lambda s: bool(rx.search(s)),
                                     np.bool_, DataType.boolean())
        if f is _F.REGEXP_COUNT:
            return _dict_lookup_host(args[0], lambda s: len(rx.findall(s)),
                                     np.int64, DataType.int64())
        # REGEXP_SUBSTR: the first match, NULL where the pattern never matches
        return _dict_map_host_nullable(
            args[0], lambda s: (lambda m: m.group(0) if m else None)(
                rx.search(s)))

    # ---- EXTRACT / DATE_TRUNC --------------------------------------------
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
            return Val(exact_div((tod % 60_000_000).to(torch.float64), 1e6),
                       valid,
                       DataType.float64())
        elif field == "epoch":
            sec = days.to(torch.float64) * 86400.0 + exact_div(
                tod.to(torch.float64), 1e6)
            return Val(sec, valid, DataType.float64())
        elif field == "milliseconds":
            out = tod % 60_000_000 // 1000
        elif field == "microseconds":
            out = tod % 60_000_000
        else:
            raise ExecutionError(f"EXTRACT field '{field}' not supported")
        return Val(out.to(torch.int64), valid, DataType.int64())

    def _eval_date_trunc(self, args: List[Val]) -> Val:
        """DATE_TRUNC(unit, temporal); the result keeps the argument's type
        (PostgreSQL widens a date to a timestamp; the reference keeps the
        column device-native)."""
        unit = self._literal_str(args[0], "DATE_TRUNC").lower()
        v = args[1]
        if not v.dtype.is_temporal:
            raise ExecutionError(
                f"DATE_TRUNC needs a date/timestamp argument, got {v.dtype}"
            )
        days, tod = _temporal_split(v)
        valid = args[0].validity & v.validity
        if unit == "microseconds":
            pass
        elif unit == "milliseconds":
            tod = tod - tod % 1000
        elif unit == "second":
            tod = tod - tod % 1_000_000
        elif unit == "minute":
            tod = tod - tod % 60_000_000
        elif unit == "hour":
            tod = tod - tod % 3_600_000_000
        elif unit == "day":
            tod = torch.zeros_like(tod)
        elif unit == "week":
            days = days - (days + 3) % 7  # back to Monday
            tod = torch.zeros_like(tod)
        elif unit in ("month", "quarter", "year"):
            y, m, _ = _civil_from_days(days)
            if unit == "quarter":
                m = ((m - 1) // 3) * 3 + 1
            elif unit == "year":
                m = torch.ones_like(m)
            days = _days_from_civil(y, m, torch.ones_like(m))
            tod = torch.zeros_like(tod)
        else:
            raise ExecutionError(f"DATE_TRUNC unit '{unit}' not supported")
        return Val(_temporal_join(days, tod, v), valid, v.dtype)

    def _eval_coalesce(self, args: List[Val]) -> Val:
        """The first non-NULL argument per row; strings through a merged
        dictionary, numbers in float64 when any argument is a float."""
        if any(a.dictionary is not None for a in args):
            out = args[0]
            for nxt in args[1:]:
                o2, n2 = unify_dicts(out, nxt)
                data = torch.where(out.validity, o2.data, n2.data)
                out = Val(data, out.validity | nxt.validity, out.dtype,
                          o2.dictionary)
            return out
        is_float = any(a.dtype.is_float for a in args)
        cast = torch.float64 if is_float else torch.int64
        data, valid = args[0].data.to(cast), args[0].validity
        for nxt in args[1:]:
            data = torch.where(valid, data, nxt.data.to(cast))
            valid = valid | nxt.validity
        return Val(data, valid,
                   DataType.float64() if is_float else args[0].dtype)

    # ---- static arguments ------------------------------------------------
    @staticmethod
    def _literal_str(v: Val, fn: str) -> str:
        if v.dictionary is None or len(v.dictionary) != 1:
            raise ExecutionError(f"{fn} requires a string literal argument")
        return v.dictionary.values[0]

    def _static_num(self, expr: lp.LogicalExpr, val: Val, fn: str):
        """A numeric argument the host needs (SUBSTRING's start and length,
        ROUND's digits, ...), read from the expression node when it is a
        (negated) literal, else from the evaluated value's first row: a
        device read, which a program body does not make (it raises, and the
        program runs eagerly)."""
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
        if self._dyn_literals is not None:
            raise ExecutionError(f"{fn} needs a literal argument inside a "
                                 "compiled program")
        return val.data[0].item()

    # ---- UDF -------------------------------------------------------------
    def _eval_udf(self, e: lp.UdfExpr, batch: ColumnBatch) -> Val:
        """A registered UDF over whole columns: it receives each argument's
        (data, validity) planes and returns the result's pair."""
        udf = self.udfs.get(e.fn_name) if self.udfs is not None else None
        if udf is None:
            raise ExecutionError(f"unknown function '{e.fn_name}'")
        args = [self.eval(a, batch) for a in e.args]
        data, validity = udf.invoke([(a.data, a.validity) for a in args])
        return Val(data, validity, udf.signature.return_type)

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
