"""The evaluator's device-side functions and operators on the card, held
against the same expressions on the CPU. Each test skips without a CUDA
GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_scalar_cuda.py -m cuda

Each expression runs in `SELECT id, <expr> FROM n ORDER BY id` on a
`Session(device="cuda")` (a first run, its capture and two replays, then
the eager executor) and on a `Session(device="cpu")`, over 4096 rows with
NULLs, zeros, negative operands, ties of ROUND, NaN, +-0, dates before 1970
and DECIMAL(10, 2) prices: %, ROUND, TRUNC, CEIL, FLOOR, ABS, SIGN, SQRT,
GREATEST/LEAST, COALESCE/NULLIF, DATE_TRUNC, EXTRACT, INTERVAL arithmetic
and decimal arithmetic and casts must give the CPU's values exactly (a
division by a constant divides on the card too: `expr_eval.exact_div`);
EXP, LN, LOG, the trigonometric functions, POWER and SQRT within rtol
1e-12 (the card's libdevice against the CPU's vectorized math). Each device-side expression runs
inside the captured program: no eager leaf.
"""

import datetime
import math

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType
from query_engine_tpu_torch.engine.session import Session

pytestmark = pytest.mark.cuda

N = 4096


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _table():
    rng = np.random.default_rng(99)
    a = rng.integers(-50, 51, N).tolist()
    b = rng.integers(-5, 6, N).tolist()
    f = (rng.normal(0, 100, N) * 8).round() / 8  # many ties at 2 digits
    f[:8] = [2.5, -2.5, 0.125, -0.125, np.nan, -0.0, 0.0, 0.005]
    g = rng.uniform(-60, 60, N)
    d = rng.integers(-30000, 20000, N)  # 1887-11 .. 2024-10
    ts = rng.integers(-2 * 10**15, 2 * 10**15, N)
    price = rng.integers(-100000, 100000, N) / 100.0
    null = rng.random((6, N)) < 0.08
    null[:, :8] = False  # the special values above stay

    def nulls(xs, m):
        return [None if k else x for x, k in zip(list(xs), m)]

    return {
        "id": list(range(N)),
        "a": nulls(a, null[0]), "b": nulls(b, null[1]),
        "f": nulls(f.tolist(), null[2]), "g": nulls(g.tolist(), null[3]),
        "d": nulls(d.tolist(), null[4]), "ts": ts.tolist(),
        "price": nulls(price.tolist(), null[5]),
        "qty": rng.integers(0, 50, N).tolist(),
    }


TYPES = {"id": DataType.int64(), "a": DataType.int64(),
         "b": DataType.int64(), "f": DataType.float64(),
         "g": DataType.float64(), "d": DataType.date32(),
         "ts": DataType.timestamp(), "price": DataType.decimal128(10, 2),
         "qty": DataType.int64()}


def _session(device):
    s = Session(device=device)
    s.register_table("n", ColumnBatch.from_pydict(
        _table(), Schema([Field(k, t) for k, t in TYPES.items()])))
    return s


EXACT = [
    "a % b", "a % 7", "-a % 3", "a % -4", "f % g", "f % 0.75", "g % 0",
    "ROUND(f)", "ROUND(f, 2)", "ROUND(f, 1)", "ROUND(-f, 2)", "ROUND(g, -1)",
    "TRUNC(f, 1)", "TRUNC(g)", "CEIL(f)", "FLOOR(g)", "ABS(f)", "ABS(a)",
    "SIGN(f)", "SIGN(a)",
    "GREATEST(a, b, 0)", "LEAST(a, b)", "GREATEST(f, g)", "LEAST(f, NULL, g)",
    "COALESCE(a, b, -1)", "COALESCE(f, g, 0.5)", "NULLIF(a, 7)",
    "NULLIF(f, 2.5)", "COUNT(*) OVER (PARTITION BY a % 3)",
    "DATE_TRUNC('quarter', d)", "DATE_TRUNC('week', d)",
    "DATE_TRUNC('year', d)", "DATE_TRUNC('month', d)",
    "DATE_TRUNC('hour', ts)", "DATE_TRUNC('day', ts)",
    "d + INTERVAL '1 month'", "d - INTERVAL '13 months'",
    "d + INTERVAL '10 days'", "ts + INTERVAL '1 day 01:30:00'",
    "ts - INTERVAL '2 months 3 hours'", "EXTRACT(quarter FROM d)",
    "price * qty", "price + price", "price * price", "price % 3",
    "price / 4", "CAST(price AS INT)", "CAST(qty AS DECIMAL(8, 3))",
    "ROUND(price, 1)", "ABS(price)", "price > 12.5",
    "CAST(price AS DOUBLE)", "EXTRACT(second FROM ts)",
    "EXTRACT(epoch FROM ts)",
]
TRANSCENDENTAL = [
    "EXP(g / 10)", "LN(g)", "LOG(g)", "LOG10(g)", "LOG(2, g)", "SIN(f)",
    "COS(f)", "TAN(g)", "ASIN(g / 100)", "ACOS(g / 100)", "ATAN(f)",
    "ATAN2(f, g)", "DEGREES(f)", "RADIANS(g)", "POWER(f, 2)",
    "POWER(ABS(g), 0.5)", "POWER(a, 3)",
    # torch's sqrt on the CPU is not always correctly rounded (1 ulp off
    # at g = 8.352502457202618); the card's is
    "SQRT(ABS(g))", "SQRT(g)",
]


def _same(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(x, float) and isinstance(y, float):
                if math.isnan(x) or math.isnan(y):
                    assert math.isnan(x) and math.isnan(y), (g, w)
                elif rtol:
                    assert math.isclose(x, y, rel_tol=rtol, abs_tol=0.0), \
                        (g, w)
                else:
                    assert x == y, (g, w)
            else:
                assert x == y and type(x) is type(y), (g, w)


def _held(cuda_device, expr, rtol):
    q = f"SELECT id, {expr} AS v FROM n ORDER BY id"
    want = _session("cpu").sql(q).to_pylist()
    s = _session("cuda")
    pipe = s.executor.pipeline
    for _ in range(4):  # first run, capture, replays
        _same(s.sql(q).to_pylist(), want, rtol)
    assert pipe.stats["replays"] >= 2, pipe.stats
    assert not pipe.leaf_kinds, pipe.leaf_kinds
    s.executor._compiled = False
    _same(s.sql(q).to_pylist(), want, rtol)


@pytest.mark.parametrize("expr", EXACT)
def test_exact_on_the_card(cuda_device, expr):
    _held(cuda_device, expr, 0.0)


@pytest.mark.parametrize("expr", TRANSCENDENTAL)
def test_transcendental_on_the_card(cuda_device, expr):
    _held(cuda_device, expr, 1e-12)


def test_grouped_functions_on_the_card(cuda_device):
    """A GROUP BY over `a % 5` with SUM/AVG/COUNT over the new functions:
    keys and counts exact, float sums (fixed point on the card, float64 on
    the CPU) within rtol 1e-9."""
    q = ("SELECT a % 5 AS k, COUNT(NULLIF(b, 0)) AS c, SUM(ROUND(f, 2)) AS s, "
         "AVG(SQRT(ABS(g))) AS r, MAX(GREATEST(f, g)) AS m, "
         "SUM(price) AS p FROM n GROUP BY a % 5 ORDER BY k")
    want = _session("cpu").sql(q).to_pylist()
    s = _session("cuda")
    for _ in range(3):
        _same(s.sql(q).to_pylist(), want, 1e-9)
    assert s.executor.pipeline.stats["replays"] >= 1


def test_replays_read_their_own_literals(cuda_device):
    """A replayed program reads new values of its input literals (`a % 7 =
    k`, a date bound minus an INTERVAL), while a new ROUND digit count is a
    new program."""
    s, cpu = _session("cuda"), _session("cpu")
    bound = ("SELECT SUM(ROUND(g, {})) FROM n WHERE d < DATE '{}' - "
             "INTERVAL '1 month'")
    for q in ("SELECT id FROM n WHERE a % 7 = 1 ORDER BY id",
              "SELECT id FROM n WHERE a % 7 = 2 ORDER BY id",
              bound.format(2, "1970-01-01"), bound.format(2, "1980-01-01"),
              bound.format(3, "1980-01-01")):
        for _ in range(2):
            _same(s.sql(q).to_pylist(), cpu.sql(q).to_pylist(), 1e-9)
    stats = s.executor.pipeline.stats
    assert stats["compiles"] == 3 and stats["captures"] == 3, stats


def test_sign_and_round_of_nan_on_the_card(cuda_device):
    """torch.sign(nan) is 0; SIGN and ROUND keep NaN, as the JAX package
    does."""
    s = _session("cuda")
    (r,) = s.sql("SELECT SIGN(f), ROUND(f, 2), ROUND(f), SIGN(-f) FROM n "
                 "WHERE id = 4").to_pylist()
    assert all(math.isnan(x) for x in r), r
    rows = s.sql("SELECT ROUND(f), ROUND(f, 2) FROM n WHERE id < 4 "
                 "ORDER BY id").to_pylist()
    assert rows == [(3.0, 2.5), (-3.0, -2.5), (0.0, 0.13), (-0.0, -0.13)]


def test_date_trunc_before_1970_on_the_card(cuda_device):
    s = _session("cuda")
    rows = s.sql("SELECT d, DATE_TRUNC('quarter', d), DATE_TRUNC('week', d) "
                 "FROM n WHERE d < DATE '1970-01-01' ORDER BY id "
                 "LIMIT 200").to_pylist()
    assert rows
    for d, q, w in rows:
        assert q == datetime.date(d.year, (d.month - 1) // 3 * 3 + 1, 1)
        assert w == d - datetime.timedelta(days=d.weekday())
