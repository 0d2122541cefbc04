"""Every window function of the JAX package, in the port, through both
Sessions: ROW_NUMBER, RANK, DENSE_RANK, NTILE, PERCENT_RANK, CUME_DIST,
FIRST/LAST/NTH_VALUE, LAG/LEAD with and without a default, and
COUNT/SUM/AVG/MIN/MAX over every frame kind, over string, float (+-inf),
int64 and date-like columns with NULLs, on the JAX Session and the port's
`Session(device="cpu")`: with the compiled pipeline on, with it off
(QE_COMPILED=0), and with the pipeline admitting nodes as on CUDA
(`_graphs = True`, `_capture` stubbed). Rows must be equal and in the same
order: integers and strings exactly, floats to rtol 1e-9. Where the JAX
package raises, the port raises the same error class.

The program cache keys NTILE's n, LAG/LEAD's offset and NTH_VALUE's n
statically: `LAG(x, 1)` then `LAG(x, 2)` (and LEAD, NTILE, NTH_VALUE) on
one Session give each query its own rows, while a literal inside a window
function's argument stays a program input.
"""

import numpy as np
import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import oracle


def _mixed_table():
    """Strings, floats with +-inf, int32-range and int64 keys, NULLs."""
    rng = np.random.default_rng(23)
    n = 400
    f = rng.integers(-400, 400, n) / 4.0
    f[rng.random(n) < 0.03] = np.inf
    f[rng.random(n) < 0.03] = -np.inf
    names = ["ash", "birch", "cedar", "elm", "fir", "oak", "pine"]
    return {
        "id": list(range(n)),
        "g": [int(x) for x in rng.integers(0, 6, n)],
        "s": [None if rng.random() < 0.1 else names[i]
              for i in rng.integers(0, len(names), n)],
        "x": [None if rng.random() < 0.15 else int(x)
              for x in rng.integers(-50, 50, n)],
        "big": [int(x) * (1 << 35) for x in rng.integers(-20, 20, n)],
        "f": [None if rng.random() < 0.1 else float(x) for x in f],
        "d": [int(x) for x in rng.integers(8000, 8040, n)],
    }


def _register(s):
    s.register_table("m", _mixed_table())


CASES = [
    # every function and frame kind, strings, +-inf, int64, date-like keys
    ("SELECT id, DENSE_RANK() OVER (PARTITION BY g ORDER BY x), "
     "NTILE(3) OVER (PARTITION BY g ORDER BY id), NTILE(50) OVER "
     "(PARTITION BY g ORDER BY id DESC) FROM m ORDER BY id"),
    ("SELECT id, FIRST_VALUE(s) OVER (PARTITION BY g ORDER BY id), "
     "LAST_VALUE(s) OVER (PARTITION BY g ORDER BY id), "
     "NTH_VALUE(f, 2) OVER (PARTITION BY g ORDER BY id ROWS "
     "BETWEEN 1 PRECEDING AND 2 FOLLOWING) FROM m ORDER BY id"),
    ("SELECT id, LAG(x, 3) OVER (PARTITION BY g ORDER BY id), "
     "LEAD(f, 2) OVER (PARTITION BY g ORDER BY id), LAG(x, 2, -1) "
     "OVER (PARTITION BY g ORDER BY id), LEAD(s, 500) OVER "
     "(ORDER BY id) FROM m ORDER BY id"),
    ("SELECT id, MIN(s) OVER (PARTITION BY g), MAX(s) OVER "
     "(PARTITION BY g ORDER BY id), MIN(f) OVER (ORDER BY id ROWS "
     "BETWEEN 4 PRECEDING AND 1 FOLLOWING), MAX(big) OVER (PARTITION "
     "BY g ORDER BY id ROWS BETWEEN 2 PRECEDING AND 3 FOLLOWING) "
     "FROM m ORDER BY id"),
    ("SELECT id, SUM(f) OVER (PARTITION BY g ORDER BY id ROWS "
     "BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW), COUNT(s) OVER "
     "(PARTITION BY s), AVG(x) OVER (PARTITION BY g ORDER BY d "
     "RANGE BETWEEN 3 PRECEDING AND 2 FOLLOWING), SUM(big) OVER "
     "(ORDER BY d DESC RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) "
     "FROM m ORDER BY id"),
    ("SELECT id, COUNT(*) OVER (ORDER BY x NULLS FIRST ROWS "
     "BETWEEN 5 PRECEDING AND 5 FOLLOWING), MAX(x) OVER (ORDER BY d "
     "RANGE BETWEEN UNBOUNDED PRECEDING AND 2 FOLLOWING), "
     "SUM(x) OVER (), COUNT(x) OVER (ORDER BY x DESC) "
     "FROM m ORDER BY id"),
    ("SELECT g, total, RANK() OVER (ORDER BY total DESC) FROM "
     "(SELECT g, SUM(x) AS total FROM m GROUP BY g) t ORDER BY g"),
    ("SELECT id, r FROM (SELECT id, ROW_NUMBER() OVER (PARTITION BY "
     "s ORDER BY f DESC, id) AS r FROM m) t WHERE r <= 2 "
     "ORDER BY id"),
]

RAISING = [
    "SELECT LAG(s, 1, 'none') OVER (ORDER BY id) FROM m",
    "SELECT SUM(x) OVER (ORDER BY d RANGE BETWEEN 1 FOLLOWING AND 2 "
    "FOLLOWING) FROM m",
    "SELECT SUM(x) OVER (ORDER BY d RANGE BETWEEN 2 PRECEDING AND 1 "
    "PRECEDING) FROM m",
    "SELECT SUM(x) OVER (ORDER BY s RANGE BETWEEN 1 PRECEDING AND CURRENT "
    "ROW) FROM m",
]


def _run(s, sql):
    try:
        return s.sql(sql).to_pylist()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__


@pytest.fixture(scope="module")
def jax_results():
    js = JSession()
    _register(js)
    return {sql: _run(js, sql) for sql in CASES + RAISING}


MODES = ["compiled", "QE_COMPILED=0", "graphs"]


def _session(mode):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
    _register(s)
    return s


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", CASES, ids=[str(i) for i in range(len(CASES))])
def test_window_function_matches_jax(jax_results, sql, mode):
    want = jax_results[sql]
    assert not isinstance(want, str), want
    s = _session(mode)
    oracle.compare(s.sql(sql).to_pylist(), want)
    if mode != "QE_COMPILED=0":
        assert s.executor.pipeline.stats["fallbacks"] == 0
        assert "Window" not in s.executor.pipeline.leaf_kinds


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", RAISING,
                         ids=[str(i) for i in range(len(RAISING))])
def test_window_function_raises_as_in_jax(jax_results, sql, mode):
    want = jax_results[sql]
    assert want == "ExecutionError", want
    assert _run(_session(mode), sql) == want


@pytest.mark.parametrize("first,second", [
    ("LAG(x, 1)", "LAG(x, 2)"),
    ("LEAD(x, 1)", "LEAD(x, 3)"),
    ("NTILE(2)", "NTILE(4)"),
    ("NTH_VALUE(x, 2)", "NTH_VALUE(x, 3)"),
])
@pytest.mark.parametrize("mode", ["compiled", "graphs"])
def test_window_parameters_key_the_program(first, second, mode):
    """NTILE's n, LAG/LEAD's offset and NTH_VALUE's n are read on the host
    while a program is built: the second query must not replay the first
    one's program."""
    js, s = JSession(), _session(mode)
    _register(js)
    compiles = []
    for fn in (first, second, first):
        q = (f"SELECT id, {fn} OVER (PARTITION BY g ORDER BY id) FROM m "
             "ORDER BY id")
        want = js.sql(q).to_pylist()
        oracle.compare(s.sql(q).to_pylist(), want)
        compiles.append(s.executor.pipeline.stats["compiles"])
    assert compiles == [1, 2, 2], compiles  # the third query hits the first


def test_window_literal_of_an_argument_is_a_program_input():
    """A literal inside a window function's argument is an input of the
    program like any other: SUM(x + 1) and SUM(x + 5) share one program."""
    js, s = JSession(), _session("compiled")
    _register(js)
    for c in (1, 5):
        q = (f"SELECT id, SUM(x + {c}) OVER (PARTITION BY g ORDER BY id) "
             "FROM m ORDER BY id")
        oracle.compare(s.sql(q).to_pylist(), js.sql(q).to_pylist())
    assert s.executor.pipeline.stats["compiles"] == 1
    assert s.executor.pipeline.stats["hits"] == 1
