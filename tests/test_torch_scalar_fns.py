"""The scalar functions, operators and casts of the port's evaluator against
the JAX package, through both Sessions.

The SQL cases of tests/test_scalar_fn_batch.py, test_temporal_fns.py,
test_interval.py, test_regex_ops.py, test_json_ops.py and test_decimal.py,
the string and COALESCE cases of test_e2e_queries.py, and cases of this
file's own (ROUND at ties, SIGN and ROUND of NaN, % with negative, zero
and float operands, GREATEST/LEAST with NULLs, DATE_TRUNC before 1970,
casts between strings and numbers, ||, @@, NULLIF, UDF calls) run on the
same tables through the JAX Session and the port's `Session(device="cpu")`:
with the compiled pipeline on, with it off (QE_COMPILED=0), and with the
pipeline admitting nodes as on CUDA (`_graphs = True`, `_capture` stubbed).
In that third mode an expression that builds a table on the host must run
as an eager leaf: a spy fails the case if a program body builds one. Rows
must be equal and in the same order: integers, strings and dates exactly,
floats to rtol 1e-9. Where the JAX package raises, the port raises the same
error class.

STRING_TO_ARRAY and ARRAY_LENGTH, which make or read LIST columns, and
UNNEST of such a column are among the cases (tests/test_torch_list_aggs.py
has the rest of the LIST forms).

Also: a program keys ROUND's digits (and the other arguments the host
reads) by value, so `ROUND(x, 2)` then `ROUND(x, 3)` on one Session give
each query its own rows.
"""

import datetime
import math
import os

import pyarrow as pa
import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.core.schema import Field as JField
from query_engine_tpu.core.schema import Schema as JSchema
from query_engine_tpu.core.types import DataType as JDataType
from query_engine_tpu.core.udf import ScalarUdf as JUdf
from query_engine_tpu.core.udf import UdfSignature as JSignature
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType
from query_engine_tpu_torch.core.udf import ScalarUdf, UdfSignature
from query_engine_tpu_torch.engine import expr_eval, pipeline
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import oracle

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")

NAN = float("nan")
DATES = [datetime.date(2024, 1, 1), datetime.date(2024, 2, 29),
         datetime.date(2024, 12, 31), datetime.date(2023, 1, 1),
         datetime.date(1969, 7, 20), datetime.date(1900, 3, 1), None]
TIMESTAMPS = [datetime.datetime(2024, 6, 15, 13, 45, 30, 250000),
              datetime.datetime(1969, 12, 31, 23, 59, 59, 999999),
              datetime.datetime(2000, 1, 1, 0, 0, 0), None]
EV_DATES = [datetime.date(2024, 1, 31), datetime.date(2024, 2, 29),
            datetime.date(1969, 12, 15)]
EV_TS = [datetime.datetime(2024, 1, 31, 23, 30),
         datetime.datetime(2024, 2, 29, 1, 0),
         datetime.datetime(1969, 12, 15, 12, 0)]
JSON_DOCS = ['{"a": {"b": [10, 20, 30]}, "name": "x", "flag": true}',
             '{"a": {"b": []}, "name": "y", "flag": false}',
             '{"a": null, "name": null}', "not json at all", None]


def _days(d):
    return None if d is None else (d - datetime.date(1970, 1, 1)).days


def _arrow(s, name, cols, jax_side):
    rb = pa.record_batch(cols)
    s.register_table(name, (JBatch if jax_side else ColumnBatch)
                     .from_arrow(rb))


def _typed(s, name, data, types, jax_side):
    """A table with explicit column types (DECIMAL, DATE32)."""
    if jax_side:
        schema = JSchema([JField(k, t(JDataType)) for k, t in types.items()])
        s.register_table(name, JBatch.from_pydict(data, schema))
    else:
        schema = Schema([Field(k, t(DataType)) for k, t in types.items()])
        s.register_table(name, ColumnBatch.from_pydict(data, schema))


def _udfs(s, jax_side):
    """twice_plus(x) = 2x + 1 over int64 and half(x) = x / 2 over float64:
    whole-column functions that work on either package's planes."""
    udf, sig = (JUdf, JSignature) if jax_side else (ScalarUdf, UdfSignature)
    T = JDataType if jax_side else DataType
    s.udfs.register(udf("twice_plus", sig((T.int64(),), T.int64()),
                        lambda args: (args[0][0] * 2 + 1, args[0][1])))
    s.udfs.register(udf("half", sig((T.float64(),), T.float64()),
                        lambda args: (args[0][0] * 0.5, args[0][1])))


def _register(s, fixture, jax_side):
    if fixture == "fn":  # tests/test_scalar_fn_batch.py
        s.register_table("t", {
            "k": [1, 1, 2, 2] * 25,
            "x": [float(i) - 30.0 for i in range(100)],
            "s": ["alpha", "beta one", "  gamma  ", None] * 25,
            "b": [True, False, None, True] * 25,
        })
        s.register_table("e", {"a": [1.0, None, None],
                               "b": [0.5, 2.0, None]})
        s.register_table("w", {"s": ["abcdef"]})
        s.register_table("bools", {"k": [1, 1, 1, 2, 2, 3],
                                   "b": [True, False, None, True, True,
                                         None]})
    elif fixture == "dates":  # tests/test_temporal_fns.py
        _arrow(s, "dates", {"id": pa.array(range(len(DATES))),
                            "d": pa.array(DATES)}, jax_side)
        _arrow(s, "tss", {"id": pa.array(range(len(TIMESTAMPS))),
                          "ts": pa.array(TIMESTAMPS,
                                         type=pa.timestamp("us"))}, jax_side)
    elif fixture == "ev":  # tests/test_interval.py
        _arrow(s, "ev", {"id": pa.array([1, 2, 3]), "d": pa.array(EV_DATES),
                         "ts": pa.array(EV_TS, type=pa.timestamp("us"))},
               jax_side)
    elif fixture == "rx":  # tests/test_regex_ops.py
        s.register_table("t", {
            "name": ["alice", "Bob", "carol", "dave123", "eve", "Frank",
                     None, "gHost"],
            "v": [10, 20, 30, 40, 50, 60, 70, 80]})
        for name, xs in (("dots", ["a.b", "axb"]), ("cats", ["cat", "cart",
                                                             "ct"]),
                         ("pct", ["50%", "50x"]), ("ban", ["banana"]),
                         ("js", ["john smith"]), ("digits", ["ab12cd"]),
                         ("apple", ["Apple and apple"]),
                         ("abc", ["ABC", "abc", "xyz"])):
            s.register_table(name, {"x": xs})
    elif fixture == "json":  # tests/test_json_ops.py
        s.register_table("t", {"doc": JSON_DOCS, "id": [1, 2, 3, 4, 5]})
        s.register_table("t2", {"csv": ["a,b", "c"]})
    elif fixture == "dec":  # tests/test_decimal.py
        _typed(s, "p", {"name": ["a", "b", "c", "d"],
                        "price": [19.99, 5.50, 0.01, None],
                        "qty": [3, 2, 100, 1]},
               {"name": lambda T: T.utf8(),
                "price": lambda T: T.decimal128(10, 2),
                "qty": lambda T: T.int64()}, jax_side)
    elif fixture == "csv":  # tests/test_e2e_queries.py
        for name in ("employees", "departments"):
            s.register_csv(name, os.path.join(DATA, f"{name}.csv"))
    elif fixture == "num":  # ties, NaN, signs, zeros, pre-1970 dates
        _typed(s, "n", {
            "id": list(range(10)),
            "a": [-7, 7, -7, 7, 0, 5, None, 12, -12, 3],
            "b": [3, -3, -3, 3, 5, 0, 2, 5, 5, None],
            "f": [2.5, -2.5, 0.125, -0.125, NAN, 1.5, -0.0, 7.25, -7.25,
                  None],
            "g": [3.0, -3.0, 0.5, 2.0, 1.0, 0.0, 2.0, -2.5, 2.5, 1.0],
            "d": [_days(x) for x in (
                datetime.date(1969, 12, 31), datetime.date(1900, 3, 1),
                datetime.date(1960, 2, 29), datetime.date(1583, 10, 17),
                datetime.date(1970, 1, 1), datetime.date(1969, 1, 1),
                None, datetime.date(2024, 12, 31),
                datetime.date(1899, 12, 31), datetime.date(1950, 6, 15))],
            "s": ["12", "3.5", "x", None, "-7", "1e3", "", "0.125", "abc",
                  "-0"],
        }, {"id": lambda T: T.int64(), "a": lambda T: T.int64(),
            "b": lambda T: T.int64(), "f": lambda T: T.float64(),
            "g": lambda T: T.float64(), "d": lambda T: T.date32(),
            "s": lambda T: T.utf8()}, jax_side)
        s.register_table("docs", {
            "id": [1, 2, 3, 4, 5],
            "body": ["The Rust book", "rust and Go", "python only", None,
                     "Go, Rust; C"]})
        _udfs(s, jax_side)
    else:
        raise ValueError(fixture)


def _fields(table, fields, col):
    return [f"SELECT id, {', '.join(f'EXTRACT({x} FROM {col})' for x in fields)}"
            f" FROM {table} ORDER BY id"]


CASES = [
    # tests/test_scalar_fn_batch.py
    ("fn", "SELECT x, EXP(x / 50), LN(x), LOG(x), LOG10(x), SIGN(x), "
           "SIN(x), COS(x), ATAN(x), DEGREES(x), RADIANS(x), TRUNC(x / 7) "
           "FROM t ORDER BY x LIMIT 100"),
    ("fn", "SELECT LOG(2, 8), ATAN2(1, 1), MOD(7, 3), MOD(-7, 3), PI(), "
           "ASIN(2), ACOS(0.5), TRUNC(1234.567, -2), TRUNC(1.999, 2) FROM t "
           "LIMIT 1"),
    ("fn", "SELECT GREATEST(a, b, 0.75), LEAST(a, b), GREATEST(a, b) "
           "FROM e"),
    ("fn", "SELECT LEFT(s, 4), RIGHT(s, 3), LPAD(LEFT(s, 2), 5, '*-'), "
           "RPAD(LEFT(s, 2), 4), REVERSE(LEFT(s, 3)), INITCAP(s), "
           "SPLIT_PART(s, ' ', 2), REPEAT(LEFT(s, 1), 2), LTRIM(s), "
           "RTRIM(s), STRPOS(s, 'a'), STARTS_WITH(s, 'be') FROM t LIMIT 4"),
    ("fn", "SELECT LEFT(s, -2), RIGHT(s, -2), LEFT(s, 0), RIGHT(s, 0) "
           "FROM w"),
    ("fn", "SELECT k, SUM(TRUNC(x, -1)), SUM(ROUND(x, 1)) FROM t "
           "WHERE EXP(x / 100) > 0.5 GROUP BY k ORDER BY k"),
    ("fn", "SELECT LEFT(s, 2), COUNT(*) FROM t GROUP BY LEFT(s, 2) "
           "ORDER BY 1"),
    ("fn", "SELECT k, BOOL_AND(b), BOOL_OR(b), EVERY(b) FROM bools "
           "GROUP BY k ORDER BY k"),
    ("fn", "SELECT BOOL_AND(k < 4), BOOL_OR(k > 2) FROM bools"),
    ("fn", "SELECT UPPER(s), LOWER(s), TRIM(s), LENGTH(s), "
           "REPLACE(s, 'a', 'A'), SUBSTRING(s, 2, 3) FROM t LIMIT 4"),
    ("fn", "SELECT k, SUM(ABS(x)), MIN(CEIL(x / 3)), MAX(FLOOR(x / 3)), "
           "SUM(SQRT(ABS(x))), SUM(POWER(x, 2)) FROM t GROUP BY k "
           "ORDER BY k"),
    ("fn", "SELECT UPPER(s) AS u, COUNT(*) FROM t GROUP BY UPPER(s) "
           "ORDER BY u"),
    ("fn", "SELECT x FROM t WHERE LENGTH(s) > 5 AND x % 7 = 1 ORDER BY x"),
    # tests/test_temporal_fns.py
    *[("dates", q) for q in _fields(
        "dates", ["year", "month", "day", "quarter", "dow", "isodow",
                  "doy", "week"], "d")],
    *[("dates", q) for q in _fields(
        "tss", ["year", "hour", "minute", "second"], "ts")],
    ("dates", "SELECT id, EXTRACT(epoch FROM ts) FROM tss WHERE id <> 1 "
              "ORDER BY id"),
    ("dates", "SELECT id, DATE_TRUNC('year', d), DATE_TRUNC('quarter', d), "
              "DATE_TRUNC('month', d), DATE_TRUNC('week', d) FROM dates "
              "ORDER BY id"),
    ("dates", "SELECT id, DATE_TRUNC('day', ts), DATE_TRUNC('hour', ts), "
              "DATE_TRUNC('minute', ts), DATE_TRUNC('second', ts), "
              "DATE_TRUNC('month', ts) FROM tss ORDER BY id"),
    ("dates", "SELECT EXTRACT(year FROM d) AS y, COUNT(*) AS c FROM dates "
              "GROUP BY EXTRACT(year FROM d) ORDER BY y"),
    ("dates", "SELECT id, EXTRACT(month FROM d), DATE_TRUNC('month', d) "
              "FROM dates WHERE d IS NOT NULL ORDER BY id"),
    ("dates", "SELECT DATE_TRUNC('quarter', d) AS q, COUNT(*) FROM dates "
              "GROUP BY DATE_TRUNC('quarter', d) ORDER BY q"),
    # tests/test_interval.py
    ("ev", "SELECT id, d + INTERVAL '1 month' FROM ev ORDER BY id"),
    ("ev", "SELECT id, d - INTERVAL '1 year' FROM ev ORDER BY id"),
    ("ev", "SELECT id, d + INTERVAL '10 days' FROM ev ORDER BY id"),
    ("ev", "SELECT id, d - INTERVAL '2 weeks' FROM ev ORDER BY id"),
    ("ev", "SELECT id, ts + INTERVAL '90 minutes' FROM ev ORDER BY id"),
    ("ev", "SELECT id, ts - INTERVAL '1 day 01:30:00' FROM ev ORDER BY id"),
    ("ev", "SELECT id, INTERVAL '1 day' + d FROM ev ORDER BY id"),
    ("ev", "SELECT id FROM ev WHERE d + INTERVAL '1 month' > '2024-03-01'"),
    ("ev", "SELECT ev.id FROM ev WHERE ev.d - ev.d = 0 ORDER BY ev.id"),
    ("ev", "SELECT id, ts + INTERVAL '3 months 12 hours' AS t2 FROM ev "
           "WHERE id > 1 ORDER BY id"),
    ("ev", "SELECT id FROM ev WHERE d <= DATE '2024-03-30' - "
           "INTERVAL '1 month' ORDER BY id"),
    # tests/test_regex_ops.py
    ("rx", "SELECT name FROM t WHERE name ~ 'ro'"),
    ("rx", "SELECT name FROM t WHERE name ~ '^[a-z]+$'"),
    ("rx", "SELECT name FROM t WHERE name ~* '^[ab]'"),
    ("rx", "SELECT name FROM t WHERE name !~ '[0-9]'"),
    ("rx", "SELECT name ~ 'a' AS m FROM t"),
    ("rx", "SELECT name FROM t WHERE name SIMILAR TO 'a'"),
    ("rx", "SELECT name FROM t WHERE name SIMILAR TO '(a|c)%'"),
    ("rx", "SELECT x FROM dots WHERE x SIMILAR TO 'a.b'"),
    ("rx", "SELECT x FROM cats WHERE x SIMILAR TO 'c_t'"),
    ("rx", "SELECT x FROM pct WHERE x SIMILAR TO '50[%]'"),
    ("rx", "SELECT name FROM t WHERE name NOT SIMILAR TO '%e%'"),
    ("rx", "SELECT REGEXP_REPLACE(name, 'a', 'X') AS r FROM t"),
    ("rx", "SELECT REGEXP_REPLACE(x, 'an', '.') AS r FROM ban"),
    ("rx", "SELECT REGEXP_REPLACE(x, 'an', '.', 'g') AS r FROM ban"),
    ("rx", r"SELECT REGEXP_REPLACE(x, '(\w+) (\w+)', '\2 \1') AS r FROM js"),
    ("rx", r"SELECT REGEXP_REPLACE(x, '[0-9]+', '<\&>') AS r FROM digits"),
    ("rx", "SELECT REGEXP_REPLACE(x, 'apple', 'pear', 'gi') AS r FROM apple"),
    ("rx", r"SELECT name FROM t WHERE REGEXP_LIKE(name, '\d')"),
    ("rx", "SELECT x FROM abc WHERE REGEXP_LIKE(x, 'abc', 'i')"),
    ("rx", "SELECT REGEXP_SUBSTR(name, '[0-9]+') AS r FROM t"),
    ("rx", "SELECT REGEXP_COUNT(name, 'a') AS c FROM t"),
    ("rx", "SELECT name FROM t WHERE name ~* 'O'"),
    ("rx", "SELECT name FROM t WHERE name !~* '[aeiou]$' ORDER BY name"),
    ("rx", "SELECT name, v FROM t WHERE name SIMILAR TO '%(a|o)%' "
           "ORDER BY v"),
    ("rx", "SELECT REGEXP_REPLACE(name, '[aeiou]', '*', 'g') AS r FROM t"),
    ("rx", "SELECT SUM(v) AS s FROM t WHERE REGEXP_LIKE(name, '^[a-z]')"),
    ("rx", "SELECT name ~ 'a' AS m, COUNT(*) AS c FROM t "
           "GROUP BY name ~ 'a' ORDER BY c, m"),
    ("rx", "SELECT v FROM t WHERE name ~ '^[a-z]+$'"),
    # tests/test_json_ops.py
    ("json", "SELECT doc -> 'name' AS j FROM t"),
    ("json", "SELECT doc ->> 'name' AS s FROM t"),
    ("json", "SELECT doc -> 'a' -> 'b' ->> 1 AS v FROM t"),
    ("json", "SELECT doc -> 'a' -> 'b' ->> -1 AS v FROM t"),
    ("json", "SELECT doc #> '{a,b,0}' AS j, doc #>> '{a,b,0}' AS s FROM t"),
    ("json", "SELECT doc ->> 'flag' AS f FROM t"),
    ("json", "SELECT JSON_EXTRACT_PATH(doc, 'a', 'b', 2) AS j FROM t"),
    ("json", "SELECT JSON_EXTRACT_PATH_TEXT(doc, 'name') AS s, id FROM t "
             "ORDER BY id"),
    ("json", "SELECT JSONB_EXTRACT_PATH_TEXT(doc, 'name') AS s FROM t"),
    ("json", "SELECT id FROM t WHERE doc ->> 'name' = 'y'"),
    ("json", "SELECT doc ->> 'flag' AS f, COUNT(*) AS n FROM t "
             "GROUP BY doc ->> 'flag' ORDER BY f"),
    ("json", "SELECT JSON_ARRAY_LENGTH(doc -> 'a' -> 'b') AS n, id FROM t "
             "ORDER BY id"),
    ("json", "SELECT JSON_TYPEOF(doc -> 'a') AS ty, id FROM t ORDER BY id"),
    ("json", "SELECT id, doc ->> 'name' AS s, JSON_TYPEOF(doc -> 'a') AS ty "
             "FROM t WHERE doc ->> 'name' = 'x'"),
    ("json", "SELECT JSON_EXTRACT_PATH(doc) AS j FROM t"),
    ("json", "SELECT JSON_TYPEOF(NULL) AS t, JSON_ARRAY_LENGTH(NULL) AS l, "
             "JSON_EXTRACT_PATH(NULL, 'a') AS p FROM t"),
    # tests/test_decimal.py
    ("dec", "SELECT price FROM p ORDER BY name"),
    ("dec", "SELECT name, price * qty FROM p ORDER BY name"),
    ("dec", "SELECT price + price, price * price, price - 0.01 FROM p "
            "WHERE name = 'a'"),
    ("dec", "SELECT SUM(price), AVG(price), MIN(price), MAX(price), "
            "COUNT(price) FROM p"),
    ("dec", "SELECT name FROM p WHERE price > 5.5 ORDER BY name"),
    ("dec", "SELECT name FROM p WHERE price = 5.5"),
    ("dec", "SELECT name FROM p WHERE price >= 1"),
    ("dec", "SELECT price / 2, price / qty FROM p WHERE name = 'b'"),
    ("dec", "SELECT CAST(price AS DOUBLE), CAST(price AS INT), "
            "CAST(qty AS DECIMAL(8, 3)) FROM p WHERE name = 'a'"),
    ("dec", "SELECT ROUND(price) FROM p WHERE name = 'b'"),
    ("dec", "SELECT price, COUNT(*) FROM p GROUP BY price ORDER BY price"),
    ("dec", "SELECT name, price * qty AS total FROM p WHERE price > 1 "
            "ORDER BY total DESC"),
    ("dec", "SELECT name, price % 3, qty % 7, -price FROM p ORDER BY name"),
    ("dec", "SELECT name, AVG(price) OVER (ORDER BY name ROWS BETWEEN 1 "
            "PRECEDING AND CURRENT ROW) FROM p ORDER BY name"),
    ("dec", "SELECT qty % 2 AS g, AVG(price), SUM(price) FROM p "
            "GROUP BY qty % 2 ORDER BY g"),
    # tests/test_e2e_queries.py
    ("csv", "SELECT UPPER(name), LENGTH(name), CONCAT(name, '!') "
            "FROM employees WHERE id <= 2 ORDER BY id"),
    ("csv", "SELECT name, COALESCE(dept_id, -1), CASE WHEN age >= 30 THEN "
            "'senior' ELSE 'junior' END FROM employees ORDER BY id"),
    ("csv", "SELECT LENGTH(name) FROM employees"),
    ("csv", "SELECT UPPER(name) FROM employees"),
    ("csv", "SELECT name || ' (' || age || ')' AS who FROM employees "
            "ORDER BY who"),
    ("csv", "SELECT COALESCE(d.dept_name, e.name) AS n FROM employees e "
            "LEFT JOIN departments d ON e.dept_id = d.dept_id ORDER BY n"),
    # % with negative, zero and float operands; ROUND at ties; NaN
    ("num", "SELECT id, a % b, a % 3, -a % 3, a % -5, MOD(a, b) FROM n "
            "ORDER BY id"),
    ("num", "SELECT id, f % g, f % 2, g % 0.5, f % 0 FROM n ORDER BY id"),
    ("num", "SELECT id, ROUND(f), ROUND(f, 2), ROUND(f, 1), ROUND(-f, 2), "
            "ROUND(g), SIGN(f), SIGN(a), ROUND(f * 10, -1) FROM n "
            "ORDER BY id"),
    ("num", "SELECT id, ABS(f), ABS(a), CEIL(f), FLOOR(f), SQRT(f), "
            "POWER(f, 2), POWER(a, 2), TRUNC(f, 1), TRUNC(f) FROM n "
            "ORDER BY id"),
    ("num", "SELECT id, GREATEST(a, b), LEAST(a, b), GREATEST(f, g, NULL), "
            "LEAST(NULL, f), GREATEST(NULL, NULL), LEAST(a, b, 0) FROM n "
            "ORDER BY id"),
    ("num", "SELECT id, COALESCE(a, b, -1), COALESCE(f, g), "
            "COALESCE(NULL, b), NULLIF(a, 7), NULLIF(f, 2.5), "
            "NULLIF(s, 'x'), COALESCE(s, 'none') FROM n ORDER BY id"),
    ("num", "SELECT id, DATE_TRUNC('year', d), DATE_TRUNC('quarter', d), "
            "DATE_TRUNC('month', d), DATE_TRUNC('week', d), "
            "DATE_TRUNC('day', d) FROM n ORDER BY id"),
    ("num", "SELECT id, d + INTERVAL '1 month', d - INTERVAL '13 months', "
            "d + INTERVAL '366 days' FROM n ORDER BY id"),
    ("num", "SELECT id, EXP(g), LN(g), LOG(2, g), LOG10(f), ATAN2(f, g), "
            "TAN(g), ASIN(g / 4), ACOS(f / 8), DEGREES(f), RADIANS(g) "
            "FROM n ORDER BY id"),
    ("num", "SELECT id, CAST(a AS VARCHAR), CAST(f AS VARCHAR), "
            "CAST(a > 0 AS VARCHAR), CAST(g AS INT), CAST(a AS DOUBLE) "
            "FROM n ORDER BY id"),
    ("num", "SELECT id, CAST(s AS DOUBLE), CAST(s AS BIGINT), "
            "CAST(s AS INT) + 1 FROM n ORDER BY id"),
    # both packages store a parsed string unscaled (ROADMAP §3)
    ("num", "SELECT id, CAST(s AS DECIMAL(10, 2)) FROM n ORDER BY id"),
    ("num", "SELECT id, s || '-' || a, CONCAT(s, a, f), a || b FROM n "
            "ORDER BY id"),
    ("num", "SELECT a % 4 AS m, COUNT(*), SUM(f), GREATEST(MAX(a), 0) "
            "FROM n GROUP BY a % 4 ORDER BY m"),
    ("num", "SELECT id FROM n WHERE ROUND(f, 1) > 0 AND a % 2 = 1 "
            "ORDER BY id"),
    ("num", "SELECT id, twice_plus(a), half(g), twice_plus(a) % 4 FROM n "
            "ORDER BY id"),
    ("num", "SELECT twice_plus(b) AS t, COUNT(*) FROM n "
            "GROUP BY twice_plus(b) ORDER BY t"),
    ("num", "SELECT id FROM docs WHERE TO_TSVECTOR(body) @@ "
            "TO_TSQUERY('rust') ORDER BY id"),
    ("num", "SELECT id, TO_TSVECTOR(body), TO_TSQUERY('Rust & !Go') "
            "FROM docs ORDER BY id"),
    ("num", "SELECT id, TO_TSVECTOR(body) @@ TO_TSQUERY('rust & !go') "
            "FROM docs ORDER BY id"),
    # the LIST functions and UNNEST
    ("json", "SELECT u.e FROM t2 CROSS JOIN LATERAL "
             "UNNEST(STRING_TO_ARRAY(t2.csv, ',')) u(e) ORDER BY u.e"),
    ("json", "SELECT STRING_TO_ARRAY(csv, ',') FROM t2"),
    ("json", "SELECT ARRAY_LENGTH(STRING_TO_ARRAY(csv, ',')) FROM t2"),
]

# the JAX package raises these; the port must raise the same class
RAISING = [
    ("fn", "SELECT BOOL_AND(k) FROM bools"),
    ("ev", "SELECT d + INTERVAL '01:30:00' FROM ev"),
    ("rx", "SELECT REGEXP_LIKE(name, 'a', 'q') FROM t"),
    ("rx", "SELECT name FROM t WHERE name ~ name"),
    ("json", "SELECT doc -> name FROM t"),
    ("num", "SELECT SPLIT_PART(s, ',', 0) FROM n"),
    ("num", "SELECT GREATEST(s, 'a') FROM n"),
    ("num", "SELECT s % 2 FROM n"),
]



def _run(s, sql):
    try:
        return s.sql(sql).to_pylist()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    cases = CASES + RAISING
    for fixture in {f for f, _ in cases}:
        js = JSession()
        _register(js, fixture, True)
        out.update({(fixture, sql): _run(js, sql)
                    for f, sql in cases if f == fixture})
    return out


MODES = ["compiled", "QE_COMPILED=0", "graphs"]


def _guard_program_bodies(s, monkeypatch):
    """As on CUDA: fail if a program body builds a table on the host (the
    evaluator's code tables and host-to-device copies, and the pipeline's
    dictionary merges)."""
    ev = s.executor.evaluator

    def spy(fn):
        def guarded(*args, **kwargs):
            assert ev._dyn_literals is None, \
                "a program body built a table on the host"
            return fn(*args, **kwargs)
        return guarded

    monkeypatch.setattr(expr_eval, "_code_table",
                        spy(expr_eval._code_table))
    monkeypatch.setattr(expr_eval, "to_tensor", spy(expr_eval.to_tensor))
    monkeypatch.setattr(pipeline, "unify_dicts", spy(pipeline.unify_dicts))


def _session(fixture, mode, monkeypatch):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
        _guard_program_bodies(s, monkeypatch)
    _register(s, fixture, False)
    return s


def _ids(cases):
    return [f"{f}-{i}" for i, (f, _) in enumerate(cases)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", CASES, ids=_ids(CASES))
def test_case_matches_jax(jax_results, fixture, sql, mode, monkeypatch):
    want = jax_results[(fixture, sql)]
    assert not isinstance(want, str), want
    s = _session(fixture, mode, monkeypatch)
    got = s.sql(sql).to_pylist()
    oracle.compare(got, want)
    if mode == "QE_COMPILED=0":
        assert s.executor.pipeline.stats["compiles"] == 0
    else:
        assert s.executor.pipeline.stats["fallbacks"] == 0, \
            s.executor.pipeline.stats


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", RAISING, ids=_ids(RAISING))
def test_case_raises_as_in_jax(jax_results, fixture, sql, mode,
                               monkeypatch):
    want = jax_results[(fixture, sql)]
    assert isinstance(want, str) and want != "NotImplementedError", want
    assert _run(_session(fixture, mode, monkeypatch), sql) == want


def test_extract_epoch_before_1970():
    """EXTRACT(epoch) of 1969-12-31 23:59:59.999999 is -1e-6: -86400 plus
    86399.999999, a cancellation that shows the last bit of tod / 1e6. XLA's
    CPU backend divides by the constant 1e6 as a multiplication by its
    reciprocal, the port divides; each result is within one ulp of 86400
    of the exact value."""
    q = "SELECT EXTRACT(epoch FROM ts) FROM tss WHERE id = 1"
    js, s = JSession(), Session(device="cpu")
    _register(js, "dates", True)
    _register(s, "dates", False)
    ((want,),), ((got,),) = js.sql(q).to_pylist(), s.sql(q).to_pylist()
    assert want == -86400.0 + 86399999999 * 1e-6
    assert got == -86400.0 + 86399999999 / 1e6
    ulp = math.ulp(86400.0)
    assert abs(got + 1e-6) <= ulp and abs(want + 1e-6) <= ulp


def test_round_and_sign_golden(jax_results):
    """Half away from zero at ties (2.5 -> 3, -2.5 -> -3, 0.125 -> 0.13 at
    two digits, where torch.round would give 2, -2 and 0.12), and NaN in
    gives NaN out of SIGN and ROUND (torch.sign(nan) is 0)."""
    rows = jax_results[("num", CASES_BY_TEXT["round"])]
    assert [r[1] for r in rows[:4]] == [3.0, -3.0, 0.0, -0.0]
    assert [r[2] for r in rows[:4]] == [2.5, -2.5, 0.13, -0.13]
    assert math.isnan(rows[4][1]) and math.isnan(rows[4][6])
    s = Session(device="cpu")
    _register(s, "num", False)
    got = s.sql(CASES_BY_TEXT["round"]).to_pylist()
    oracle.compare(got, rows)


def test_mod_golden(jax_results):
    """SQL's % takes the dividend's sign; a zero divisor gives NULL."""
    rows = jax_results[("num", CASES_BY_TEXT["mod"])]
    assert [r[1] for r in rows[:6]] == [-1, 1, -1, 1, 0, None]
    s = Session(device="cpu")
    _register(s, "num", False)
    assert s.sql(CASES_BY_TEXT["mod"]).to_pylist() == rows


CASES_BY_TEXT = {
    "round": next(q for f, q in CASES if q.startswith("SELECT id, ROUND(f)")),
    "mod": next(q for f, q in CASES if q.startswith("SELECT id, a % b")),
}


@pytest.mark.parametrize("mode", ["compiled", "graphs"])
def test_program_keys_static_arguments(mode, monkeypatch):
    """ROUND(x, 2) then ROUND(x, 3) on one Session: the digits key the
    program, so the second query does not replay the first's digits (as
    tests/test_scalar_fn_batch.py::test_compiled_pipeline_keeps_static_args
    holds for the JAX package); a literal elsewhere stays a program
    input."""
    s = _session("fn", mode, monkeypatch)
    js = JSession()
    _register(js, "fn", True)
    pipe = s.executor.pipeline
    for q in ("SELECT k, SUM(ROUND(x / 7, 2)) FROM t GROUP BY k ORDER BY k",
              "SELECT k, SUM(ROUND(x / 7, 3)) FROM t GROUP BY k ORDER BY k",
              "SELECT k, SUM(TRUNC(x / 7, 1)) FROM t WHERE x > 3 GROUP BY k "
              "ORDER BY k",
              "SELECT k, SUM(TRUNC(x / 7, 2)) FROM t WHERE x > 5 GROUP BY k "
              "ORDER BY k"):
        oracle.compare(s.sql(q).to_pylist(), js.sql(q).to_pylist())
    assert pipe.stats["compiles"] == 4, pipe.stats
    q = "SELECT k, SUM(ROUND(x / 7, 2)) FROM t WHERE x > {} GROUP BY k " \
        "ORDER BY k"
    before = pipe.stats["compiles"]
    for lo in (3, 9):
        oracle.compare(s.sql(q.format(lo)).to_pylist(),
                       js.sql(q.format(lo)).to_pylist())
    assert pipe.stats["compiles"] == before + 1, pipe.stats
    assert pipe.stats["fallbacks"] == 0, pipe.stats


def test_host_table_expressions_are_eager_leaves_under_graphs(monkeypatch):
    """As on CUDA, a filter over a regex and a GROUP BY over UPPER run as
    eager leaves, while the numeric functions above them stay in a
    program."""
    s = _session("fn", "graphs", monkeypatch)
    pipe = s.executor.pipeline
    s.sql("SELECT k, SUM(ROUND(x, 1)), MAX(ABS(x % 7)) FROM t "
          "WHERE s ~ '^a' GROUP BY k ORDER BY k").to_pylist()
    assert pipe.leaf_kinds["Filter"] == 1, pipe.leaf_kinds
    assert pipe.stats["compiles"] == 1, pipe.stats
    s.sql("SELECT k, SUM(ROUND(x, 1)), MAX(ABS(x % 7)) FROM t "
          "GROUP BY k ORDER BY k").to_pylist()
    assert pipe.leaf_kinds["Filter"] == 1, pipe.leaf_kinds
