"""STRING_AGG, ARRAY_AGG (LIST result columns), UNNEST and the LIST
functions STRING_TO_ARRAY, ARRAY_TO_STRING and ARRAY_LENGTH in the port
against the JAX package.

The SQL cases of tests/test_statistics_aggs.py's STRING_AGG and ARRAY_AGG
tests (their mesh cases stay out), tests/test_unnest.py and
tests/test_array_fns.py, plus NaN and NULL order keys, DESC ties, DISTINCT
with NULLs, a LIST column carried through ORDER BY and GROUP BY, and a
LIST dictionary whose lists all have one length, run through the JAX
Session and the port's `Session(device="cpu")`: with the compiled pipeline
on, with it off (QE_COMPILED=0), and with the pipeline admitting nodes as
on CUDA (`_graphs = True`, `_capture` stubbed), where a spy fails any host
table built inside a program body. Rows must be equal and in the same
order: integers, strings and lists exactly, floats to rtol 1e-9. Where the
JAX package raises, the port raises the same error class.
"""

import math

import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine import expr_eval, pipeline
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import oracle


def _register(s, fixture):
    if fixture == "sa":  # STRING_AGG
        s.register_table("e", {"k": [1, 1, 1, 2, 2, 3],
                               "s": ["a", "b", None, "x", "y", None]})
    elif fixture == "aa":  # ARRAY_AGG
        s.register_table("e", {"k": [1, 1, 1, 2, 3],
                               "v": [5, None, 7, 9, None],
                               "s": ["a", "b", None, "c", None]})
        s.register_table("f", {"k": [1, 1, 1, 2, 2],
                               "v": [5, None, 7, 1, 2]})
    elif fixture == "ao":  # in-call ORDER BY and DISTINCT
        s.register_table("e", {"k": [1, 1, 1, 2, 2],
                               "v": [3, 1, 2, 5, 4],
                               "s": ["c", "a", "b", "e", "d"]})
        s.register_table("n", {"v": [1, 2, 3], "o": [None, 2, 1]})
        s.register_table("d", {"v": [2, 2, 1, 1]})
        s.register_table("ds", {"s": ["b", "a", "b", "a"]})
        # float keys with NaN and NULL, DESC ties, NULL elements
        s.register_table("x", {
            "k": [1, 1, 1, 1, 2, 2, 2, 2, 2],
            "f": [2.5, float("nan"), -1.0, 2.5, None, 0.0, -0.0,
                  float("nan"), 1.0],
            "i": [4, 4, 1, None, 7, 7, 7, None, 2],
            "s": ["p", "q", None, "r", "s", None, "t", "u", "u"],
            "d": [11324, 10717, None, 11324, 0, -1, None, 18321, 0],
        })
    elif fixture == "un":  # tests/test_unnest.py
        s.register_table("t", {"k": [1, 1, 2, 2, 3],
                               "x": [10, 20, 30, 40, 50]})
        s.register_table("w", {"g": ["a", "a", "b"],
                               "name": ["x", "y", "z"]})
    elif fixture == "af":  # tests/test_array_fns.py
        s.register_table("t", {"csv": ["a,b,c", "x", "", "a,b,c", None]})
        s.register_table("g", {"k": [1, 1, 2], "x": [5, 7, 9]})
        # every list of one length: Dictionary.map_values makes a 2-D
        # code table in both packages
        s.register_table("q", {"s": ["a,b", "c,d", "a,b"]})
    else:
        raise ValueError(fixture)


D = "(SELECT k, ARRAY_AGG(x) AS arr FROM t GROUP BY k) d"

CASES = [
    # tests/test_statistics_aggs.py: STRING_AGG
    ("sa", "SELECT k, STRING_AGG(s, ', ') FROM e GROUP BY k ORDER BY k"),
    ("sa", "SELECT STRING_AGG(s, '|') FROM e"),
    ("sa", "SELECT STRING_AGG(s, '-') FILTER (WHERE s > 'a') FROM e"),
    ("sa", "SELECT STRING_AGG(s, ',') FROM e WHERE s = 'zz'"),
    # ARRAY_AGG
    ("aa", "SELECT k, ARRAY_AGG(v), ARRAY_AGG(s) FROM e GROUP BY k "
           "ORDER BY k"),
    ("aa", "SELECT ARRAY_AGG(v) FROM e WHERE v > 100"),
    ("aa", "SELECT k, ARRAY_AGG(v) FILTER (WHERE v > 1) AS a FROM f "
           "GROUP BY k ORDER BY k"),
    ("aa", "SELECT ARRAY_AGG(v) FILTER (WHERE v > 100) FROM f"),
    ("aa", "SELECT ARRAY_AGG(v) FILTER (WHERE v > 4) AS a, "
           "ARRAY_AGG(v) FILTER (WHERE v < 4) AS b FROM f"),
    ("ao", "SELECT k, ARRAY_AGG(v ORDER BY v) AS a FROM e GROUP BY k "
           "ORDER BY k"),
    ("ao", "SELECT k, ARRAY_AGG(s ORDER BY v DESC) AS a FROM e GROUP BY k "
           "ORDER BY k"),
    ("ao", "SELECT ARRAY_AGG(v ORDER BY s DESC) FILTER (WHERE v <> 5) "
           "FROM e"),
    ("ao", "SELECT ARRAY_AGG(v ORDER BY o) FROM n"),
    ("ao", "SELECT ARRAY_AGG(v ORDER BY o NULLS FIRST) FROM n"),
    ("ao", "SELECT ARRAY_AGG(DISTINCT v ORDER BY v) FROM d"),
    ("ao", "SELECT k, STRING_AGG(s, ',' ORDER BY v) AS sa FROM e GROUP BY k "
           "ORDER BY k"),
    ("ao", "SELECT STRING_AGG(s, '|' ORDER BY s DESC) FROM e"),
    ("ao", "SELECT STRING_AGG(DISTINCT s, ',' ORDER BY s) FROM ds"),
    # NaN and NULL order keys, DESC ties, several keys, DISTINCT
    # with NULL elements
    ("ao", "SELECT k, ARRAY_AGG(i ORDER BY f), ARRAY_AGG(s ORDER BY f DESC) "
           "FROM x GROUP BY k ORDER BY k"),
    ("ao", "SELECT k, ARRAY_AGG(s ORDER BY i DESC), "
           "ARRAY_AGG(f ORDER BY i NULLS FIRST, s DESC) FROM x GROUP BY k "
           "ORDER BY k"),
    ("ao", "SELECT k, ARRAY_AGG(d ORDER BY d DESC NULLS LAST), "
           "STRING_AGG(s, '+' ORDER BY d, i DESC) FROM x GROUP BY k "
           "ORDER BY k"),
    ("ao", "SELECT ARRAY_AGG(DISTINCT i), ARRAY_AGG(DISTINCT s ORDER BY s), "
           "STRING_AGG(DISTINCT s, '') FROM x"),
    ("ao", "SELECT k, ARRAY_AGG(f), COUNT(*), SUM(i) FROM x GROUP BY k "
           "ORDER BY k"),
    # tests/test_unnest.py
    ("un", f"SELECT d.k, u.e FROM {D}, UNNEST(d.arr) AS u(e) "
           "ORDER BY d.k, u.e"),
    ("un", f"SELECT d.k, SUM(u.e) AS s FROM {D}, UNNEST(d.arr) u(e) "
           "GROUP BY d.k ORDER BY d.k"),
    ("un", "SELECT d.g, u.nm FROM (SELECT g, ARRAY_AGG(name) AS names "
           "FROM w GROUP BY g) d, UNNEST(d.names) u(nm) ORDER BY d.g, u.nm"),
    ("un", "SELECT u.e FROM (SELECT k, ARRAY_AGG(x) FILTER (WHERE x > 25) "
           "AS arr FROM t GROUP BY k) d, UNNEST(d.arr) u(e) ORDER BY u.e"),
    ("un", "SELECT unnest FROM (SELECT ARRAY_AGG(x) AS arr FROM t) d, "
           "UNNEST(d.arr) ORDER BY unnest LIMIT 2"),
    # the explosion's own row order, a LIST column carried through
    # ORDER BY and GROUP BY (ordered by its codes, in both packages)
    ("un", f"SELECT d.k, d.arr, u.e FROM {D}, UNNEST(d.arr) u(e)"),
    ("un", "SELECT d.k, u.e FROM (SELECT k, ARRAY_AGG(x ORDER BY x DESC) "
           "AS arr FROM t GROUP BY k) d, UNNEST(d.arr) u(e)"),
    ("un", f"SELECT d.k, d.arr FROM {D} ORDER BY d.arr"),
    ("un", f"SELECT d.arr, COUNT(*) FROM {D} GROUP BY d.arr"),
    # tests/test_array_fns.py
    ("af", "SELECT ARRAY_LENGTH(STRING_TO_ARRAY(csv, ',')) AS n FROM t"),
    ("af", "SELECT u.e FROM t, UNNEST(STRING_TO_ARRAY(t.csv, ',')) u(e) "
           "ORDER BY u.e"),
    ("af", "SELECT ARRAY_TO_STRING(STRING_TO_ARRAY(csv, ','), '-') AS j "
           "FROM t"),
    ("af", "SELECT k, ARRAY_TO_STRING(ARRAY_AGG(x ORDER BY x DESC), '|') "
           "AS j FROM g GROUP BY k ORDER BY k"),
    ("af", "SELECT k, ROUND(AVG(x), 1) AS a FROM g GROUP BY k ORDER BY k"),
    ("af", "SELECT k, CASE WHEN SUM(x) > 10 THEN 'big' ELSE 'small' END "
           "AS c FROM g GROUP BY k ORDER BY k"),
    ("af", "SELECT STRING_TO_ARRAY(csv, ','), csv FROM t"),
    ("af", "SELECT u.e FROM t CROSS JOIN LATERAL "
           "UNNEST(STRING_TO_ARRAY(t.csv, ',')) u(e) ORDER BY u.e"),
    ("af", "SELECT u.e, COUNT(*) FROM t, UNNEST(STRING_TO_ARRAY(csv, ',')) "
           "u(e) WHERE ARRAY_LENGTH(STRING_TO_ARRAY(csv, ',')) > 1 "
           "GROUP BY u.e ORDER BY u.e"),
    # the 2-D code table: ARRAY_LENGTH gives each row a list of ones
    ("af", "SELECT ARRAY_LENGTH(STRING_TO_ARRAY(s, ',')) FROM q"),
]

# the JAX package raises these; the port must raise the same class
RAISING = [
    ("sa", "SELECT STRING_AGG(k, ',') FROM e"),
    ("sa", "SELECT STRING_AGG(s, k) FROM e"),
    ("ao", "SELECT SUM(v ORDER BY v) FROM d"),
    ("un", "SELECT * FROM t, UNNEST(t.x) u(e)"),
    ("un", "SELECT * FROM t LEFT JOIN UNNEST(t.x) u(e) ON TRUE"),
    # the 2-D code table: reading the lists back fails in both packages
    ("af", "SELECT STRING_TO_ARRAY(s, ',') FROM q"),
    ("af", "SELECT ARRAY_TO_STRING(STRING_TO_ARRAY(s, ','), '-') FROM q"),
    ("af", "SELECT u.e FROM q, UNNEST(STRING_TO_ARRAY(s, ',')) u(e)"),
]


def _nan_free(rows):
    """NaN inside a list cell as a string: Python's list == compares
    elements with ==, and NaN != NaN."""
    def cell(c):
        if isinstance(c, list):
            return [("NaN" if isinstance(x, float) and math.isnan(x) else x)
                    for x in c]
        return c

    return [tuple(cell(c) for c in r) for r in rows]


def _run(s, sql):
    try:
        return _nan_free(s.sql(sql).to_pylist())
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for fixture in {f for f, _ in CASES + RAISING}:
        js = JSession()
        _register(js, fixture)
        out.update({(fixture, sql): _run(js, sql)
                    for f, sql in CASES + RAISING if f == fixture})
    return out


MODES = ["compiled", "QE_COMPILED=0", "graphs"]


def _guard_program_bodies(s, monkeypatch):
    """As on CUDA: fail if a program body builds a table on the host."""
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
    _register(s, fixture)
    return s


def _ids(cases):
    return [f"{f}-{i}" for i, (f, _) in enumerate(cases)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", CASES, ids=_ids(CASES))
def test_case_matches_jax(jax_results, fixture, sql, mode, monkeypatch):
    want = jax_results[(fixture, sql)]
    assert not isinstance(want, str), want
    s = _session(fixture, mode, monkeypatch)
    oracle.compare(_nan_free(s.sql(sql).to_pylist()), want)
    pipe = s.executor.pipeline
    if mode == "QE_COMPILED=0":
        assert pipe.stats["compiles"] == 0, pipe.stats
    else:
        assert pipe.stats["fallbacks"] == 0, pipe.stats


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture,sql", RAISING, ids=_ids(RAISING))
def test_case_raises_as_in_jax(jax_results, fixture, sql, mode,
                               monkeypatch):
    want = jax_results[(fixture, sql)]
    assert isinstance(want, str) and want != "NotImplementedError", want
    assert _run(_session(fixture, mode, monkeypatch), sql) == want


def test_golden_rows(jax_results):
    """The reference tests' expected rows, which both packages give."""
    def rows(start):
        (key,) = [k for k in CASES if k[1].startswith(start)]
        return jax_results[key]

    assert rows("SELECT k, STRING_AGG(s, ', ')") == [
        (1, "a, b"), (2, "x, y"), (3, None)]
    assert rows("SELECT k, ARRAY_AGG(v), ARRAY_AGG(s)") == [
        (1, [5, None, 7], ["a", "b", None]), (2, [9], ["c"]),
        (3, [None], [None])]
    assert rows("SELECT ARRAY_AGG(v) FILTER (WHERE v > 4)") == [
        ([5, 7], [1, 2])]
    assert rows("SELECT ARRAY_AGG(v ORDER BY o NULLS FIRST)") == [
        ([1, 3, 2],)]
    assert rows("SELECT d.k, u.e FROM (SELECT k, ARRAY_AGG(x) AS arr FROM t "
                "GROUP BY k) d, UNNEST(d.arr) AS") == [
        (1, 10), (1, 20), (2, 30), (2, 40), (3, 50)]
    assert rows("SELECT ARRAY_LENGTH(STRING_TO_ARRAY(csv") == [
        (3,), (1,), (0,), (3,), (None,)]
    assert rows("SELECT ARRAY_LENGTH(STRING_TO_ARRAY(s") == [
        ([1, 1],), ([1, 1],), ([1, 1],)]


def test_unnest_reads_the_total_once(monkeypatch):
    """UNNEST reads one scalar from the device (the total) and explodes on
    the device; each dictionary value's list is read once, not each row's,
    and a warm query finds the same element column again."""
    s = _session("un", "QE_COMPILED=0", monkeypatch)
    s.register_table("big", {"k": list(range(3000)),
                             "s": ["a b c", "d", "", None, "e f"] * 600})
    sql = "SELECT b.k, u.w FROM big b, UNNEST(STRING_TO_ARRAY(b.s, ' ')) u(w)"
    want = []
    for k, text in zip(range(3000), ["a b c", "d", "", None, "e f"] * 600):
        want += [(k, w) for w in (text.split(" ") if text else [])]
    ex = s.executor
    syncs = ex.host_syncs
    batch = s.sql(sql)
    assert batch.to_pylist() == want
    first = ex.host_syncs - syncs
    elems = batch.columns[-1].dictionary
    syncs = ex.host_syncs
    again = s.sql(sql)
    assert again.to_pylist() == want
    assert ex.host_syncs - syncs == first
    assert again.columns[-1].dictionary is elems
    assert ex.host_ms["unnest"] > 0
