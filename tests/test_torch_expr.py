"""The port's evaluator for the TPC-H expressions, against the JAX package.

Each case runs one query through the port's Session and the JAX Session on
the same small table, with the compiled pipeline on and off in the port:
a date or timestamp against a string literal (both ways round), CAST and
DATE '...', dates before 1970, 29 February and NULL dates, every EXTRACT
field the JAX evaluator supports, CASE (searched and simple, with and
without ELSE, NULL conditions, string results), IN and NOT IN with NULL in
the list and in the column, LIKE, NOT LIKE, ILIKE and NOT ILIKE with %, _
and an empty pattern, UPPER and `~`. Rows must be identical and in the same order;
floats compare exactly too, since both packages compute them with the same
float64 operations.
"""

import datetime

import pytest

from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.core.schema import Field as JField
from query_engine_tpu.core.schema import Schema as JSchema
from query_engine_tpu.core.types import DataType as JType
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType
from query_engine_tpu_torch.engine.session import Session

EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - EPOCH).days


def _us(y, m, d, hh=0, mm=0, ss=0, us=0):
    t = datetime.datetime(y, m, d, hh, mm, ss, us)
    return int((t - datetime.datetime(1970, 1, 1)).total_seconds()) \
        * 1_000_000 + us


ROWS = {
    "id": [0, 1, 2, 3, 4, 5, 6, 7],
    "d": [_days(1995, 3, 15), _days(2000, 2, 29), _days(1969, 12, 31),
          _days(1900, 3, 1), None, _days(1970, 1, 1), _days(2024, 12, 31),
          _days(1960, 2, 29)],
    "ts": [_us(1995, 3, 15, 13, 45, 30, 250_000), _us(2000, 2, 29, 23, 59, 59),
           _us(1969, 12, 31, 23, 0, 1, 5), None, _us(1900, 3, 1, 0, 0, 0, 1),
           _us(1970, 1, 1), _us(2024, 12, 31, 12), _us(1960, 2, 29, 6, 30)],
    "x": [1, 2, None, 4, 5, None, 7, 2],
    "f": [1.5, -2.0, 0.0, None, 10.25, 3.0, -0.5, 7.0],
    "s": ["abc", "a_c", "", "ABC", None, "x%y", "1995-03-15", "abcabc"],
    "ds": ["1995-03-15", "2000-02-29", "not a date", None, "1969-12-31",
           "1970-01-01", "2024-12-31", "1960-02-29"],
}
TYPES = {"id": "int64", "d": "date32", "ts": "timestamp", "x": "int64",
         "f": "float64", "s": "utf8", "ds": "utf8"}


@pytest.fixture(scope="module")
def sessions():
    jb = JBatch.from_pydict(ROWS, JSchema(
        [JField(k, getattr(JType, t)()) for k, t in TYPES.items()]))
    tb = ColumnBatch.from_pydict(ROWS, Schema(
        [Field(k, getattr(DataType, t)()) for k, t in TYPES.items()]))
    js, compiled, eager = JSession(), Session("cpu"), Session("cpu")
    eager.executor._compiled = False
    js.register_table("t", jb)
    for s in (compiled, eager):
        s.register_table("t", tb)
    return js, compiled, eager


def _check(sessions, query):
    js, compiled, eager = sessions
    want = js.sql(query)
    for s in (compiled, eager):
        got = s.sql(query)
        assert got.to_pylist() == want.to_pylist(), query
        assert got.schema.names() == want.schema.names()
    return want.to_pylist()


DATE_CASES = [
    "SELECT id FROM t WHERE d < '1995-03-15' ORDER BY id",
    "SELECT id FROM t WHERE '1995-03-15' > d ORDER BY id",
    "SELECT id FROM t WHERE d = '2000-02-29'",
    "SELECT id FROM t WHERE '1969-12-31' <= d ORDER BY id",
    "SELECT id FROM t WHERE d <> '1970-01-01' ORDER BY id",
    "SELECT id FROM t WHERE d BETWEEN '1900-03-01' AND '1969-12-31' "
    "ORDER BY id",
    "SELECT id FROM t WHERE d BETWEEN DATE '1960-01-01' AND DATE "
    "'2000-02-29' ORDER BY id",
    "SELECT id FROM t WHERE d >= CAST('1970-01-01' AS DATE) ORDER BY id",
    "SELECT id, d FROM t WHERE d IS NULL OR d > '2000-01-01' ORDER BY id",
    "SELECT id FROM t WHERE ts > '1995-03-15 13:45:30' ORDER BY id",
    "SELECT id FROM t WHERE '1970-01-01' > ts ORDER BY id",
    "SELECT id, d FROM t ORDER BY d DESC NULLS LAST, id",
    "SELECT id, CAST(ds AS DATE) FROM t ORDER BY id",
    "SELECT id FROM t WHERE CAST(ds AS DATE) = d ORDER BY id",
    "SELECT id, CAST(ds AS TIMESTAMP) FROM t ORDER BY id",
    "SELECT DATE '2000-02-29', CAST('1969-12-31' AS DATE) FROM t "
    "WHERE id = 0",
]


@pytest.mark.parametrize("query", DATE_CASES)
def test_date_literals_and_casts_match_jax(sessions, query):
    _check(sessions, query)


def test_date_literal_rows(sessions):
    """Golden rows: 1900-03-01, 1969-12-31 and 1960-02-29 are before
    1995-03-15; the NULL date is not."""
    got = _check(sessions, DATE_CASES[0])
    assert got == [(2,), (3,), (5,), (7,)]


def test_date_against_a_string_that_is_not_a_date_raises(sessions):
    _, compiled, eager = sessions
    for s in (compiled, eager):
        with pytest.raises(Exception):
            s.sql("SELECT id FROM t WHERE d < 'yesterday'").to_pylist()


FIELDS = ["year", "month", "day", "quarter", "decade", "century",
          "millennium", "dow", "isodow", "doy", "week", "hour", "minute",
          "second", "epoch", "milliseconds", "microseconds"]


@pytest.mark.parametrize("field", FIELDS)
def test_extract_matches_jax(sessions, field):
    _check(sessions, f"SELECT id, EXTRACT({field} FROM d), "
                     f"EXTRACT({field} FROM ts) FROM t ORDER BY id")


def test_extract_in_group_by_and_filter(sessions):
    got = _check(sessions,
                 "SELECT y, COUNT(*), SUM(f) FROM (SELECT EXTRACT(year FROM "
                 "d) AS y, f FROM t WHERE EXTRACT(month FROM d) <= 3) q "
                 "GROUP BY y ORDER BY y DESC")
    assert [r[0] for r in got] == [2000, 1995, 1970, 1960, 1900]


def test_other_scalar_functions_still_raise(sessions):
    """UPPER, which raised before the port had the string functions, gives
    the JAX Session's rows; so does STRING_TO_ARRAY, which raised before the
    port had LIST values."""
    got = _check(sessions, "SELECT id, UPPER(s), LOWER(ds) FROM t "
                           "ORDER BY id")
    assert [r[1] for r in got[:4]] == ["ABC", "A_C", "", "ABC"]
    got = _check(sessions, "SELECT id, STRING_TO_ARRAY(s, '_') FROM t "
                           "ORDER BY id")
    assert [r[1] for r in got[:2]] == [["abc"], ["a", "c"]]


CASE_CASES = [
    "SELECT id, CASE WHEN x > 2 THEN 'big' WHEN x > 1 THEN 'two' "
    "ELSE 'small' END FROM t ORDER BY id",
    "SELECT id, CASE WHEN x > 2 THEN f END FROM t ORDER BY id",
    "SELECT id, CASE WHEN x > 2 THEN 1 ELSE 0 END FROM t ORDER BY id",
    "SELECT id, CASE x WHEN 2 THEN 'b' WHEN 7 THEN 'g' END FROM t "
    "ORDER BY id",
    "SELECT id, CASE x WHEN 2 THEN 20 ELSE x END FROM t ORDER BY id",
    "SELECT id, CASE WHEN f > 0 THEN f * 2 ELSE 0 END FROM t ORDER BY id",
    "SELECT id, CASE WHEN s LIKE 'a%' THEN s ELSE ds END FROM t ORDER BY id",
    "SELECT SUM(CASE WHEN d < '1970-01-01' THEN 1 ELSE 0 END), "
    "SUM(CASE WHEN s = 'abc' THEN f ELSE 0 END) FROM t",
    "SELECT id FROM t WHERE CASE WHEN x IS NULL THEN id > 4 ELSE x < 3 END "
    "ORDER BY id",
]


@pytest.mark.parametrize("query", CASE_CASES)
def test_case_matches_jax(sessions, query):
    _check(sessions, query)


def test_case_with_null_conditions_falls_through(sessions):
    """A NULL condition is not true: the row takes ELSE, or NULL without
    one."""
    got = _check(sessions, CASE_CASES[1])
    assert [r[1] for r in got] == [None, None, None, None, 10.25, None, -0.5,
                                   None]


IN_CASES = [
    "SELECT id FROM t WHERE x IN (1, 2) ORDER BY id",
    "SELECT id FROM t WHERE x NOT IN (1, 2) ORDER BY id",
    "SELECT id, x IN (1, NULL) FROM t ORDER BY id",
    "SELECT id, x NOT IN (1, NULL) FROM t ORDER BY id",
    "SELECT id FROM t WHERE x NOT IN (1, NULL) ORDER BY id",
    "SELECT id FROM t WHERE s IN ('abc', 'ABC', 'zzz') ORDER BY id",
    "SELECT id FROM t WHERE s NOT IN ('abc', '') ORDER BY id",
    "SELECT id, s IN ('abc', NULL) FROM t ORDER BY id",
    "SELECT id FROM t WHERE f IN (1.5, 7, -0.5) ORDER BY id",
    "SELECT x, COUNT(*) FROM t WHERE x IN (2, 7) GROUP BY x ORDER BY x",
]


@pytest.mark.parametrize("query", IN_CASES)
def test_in_list_matches_jax(sessions, query):
    _check(sessions, query)


def test_in_list_three_valued(sessions):
    """x IN (1, NULL) is true for 1 and NULL otherwise, never false."""
    got = _check(sessions, IN_CASES[2])
    assert [r[1] for r in got] == [True, None, None, None, None, None, None,
                                   None]


LIKE_CASES = [
    "SELECT id FROM t WHERE s LIKE 'a%' ORDER BY id",
    "SELECT id FROM t WHERE s LIKE '%c' ORDER BY id",
    "SELECT id FROM t WHERE s LIKE 'a_c' ORDER BY id",
    "SELECT id FROM t WHERE s LIKE '%b%' ORDER BY id",
    "SELECT id FROM t WHERE s LIKE '' ORDER BY id",
    "SELECT id FROM t WHERE s LIKE '%' ORDER BY id",
    "SELECT id FROM t WHERE s LIKE '___' ORDER BY id",
    "SELECT id FROM t WHERE s LIKE 'x%y' ORDER BY id",
    "SELECT id FROM t WHERE s LIKE 'a.c' ORDER BY id",
    "SELECT id FROM t WHERE s NOT LIKE 'a%' ORDER BY id",
    "SELECT id FROM t WHERE s ILIKE 'abc%' ORDER BY id",
    "SELECT id FROM t WHERE s NOT ILIKE 'abc' ORDER BY id",
    "SELECT id, s LIKE '%c%' FROM t ORDER BY id",
    "SELECT id FROM t WHERE ds LIKE '19%' AND s NOT LIKE '%a%' ORDER BY id",
]


@pytest.mark.parametrize("query", LIKE_CASES)
def test_like_matches_jax(sessions, query):
    _check(sessions, query)


def test_like_rows(sessions):
    """'' matches only the empty string; _ is one character; NULL matches
    nothing, not even NOT LIKE."""
    assert _check(sessions, LIKE_CASES[4]) == [(2,)]
    assert _check(sessions, LIKE_CASES[6]) == [(0,), (1,), (3,), (5,)]
    assert _check(sessions, LIKE_CASES[9]) == [(2,), (3,), (5,), (6,)]


def test_regex_match_still_raises(sessions):
    """`s ~ 'a.c'`, which raised before the port had the regex operators,
    gives the JAX Session's rows; a pattern that is not a literal raises
    ExecutionError in both packages."""
    assert _check(sessions, "SELECT id FROM t WHERE s ~ 'a.c' "
                            "ORDER BY id") == [(0,), (1,), (7,)]
    js, compiled, eager = sessions
    from query_engine_tpu.core.errors import ExecutionError as JError
    from query_engine_tpu_torch.core.errors import ExecutionError

    with pytest.raises(JError):
        js.sql("SELECT id FROM t WHERE s ~ ds").to_pylist()
    for s in (compiled, eager):
        with pytest.raises(ExecutionError):
            s.sql("SELECT id FROM t WHERE s ~ ds").to_pylist()
