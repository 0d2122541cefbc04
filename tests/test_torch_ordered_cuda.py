"""The ordered-set aggregates' device work on the card, held against the
same tensors on the CPU, and the statements of `tpch/ordered.py` through a
CUDA Session against a CPU Session. Each test skips without a CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_ordered_cuda.py -m cuda

* `QueryExecutor._grouped_percentile` (one sort by group and value, then
  the CONT lerp, the DISC index or MODE's run scan) on CUDA planes of 2^20
  rows with NaN of both signs, -0.0, infinities, NULLs, ties, an all-NULL
  group and empty groups gives the CPU's bits: both sorts are stable over
  the same keys, and the rest is the same float64 operations.
* O1-O6 through `Session(device="cuda")` (first run, two warm runs, the
  eager executor) give the rows of `Session(device="cpu")` and the numpy
  oracle: integers and strings exactly, floats to rtol 1e-9 (the card sums
  floats in fixed point).
"""

import types

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.engine.executor import QueryExecutor
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.tpch import data, oracle, ordered

pytestmark = pytest.mark.cuda

N, LIVE, OUT_CAP = 1 << 20, (1 << 20) - 77, 1024


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(12)
    gid = rng.integers(0, 1000, N).astype(np.int64)
    valid = rng.random(N) > 0.1
    valid[gid == 999] = False
    vals = rng.choice([-2.5, -1.0, 0.0, 0.5, 1.0, 3.25], N)
    special = rng.random(N)
    vals = np.where(special < 0.02, np.nan, vals)
    vals = np.where((special > 0.02) & (special < 0.03), -np.nan, vals)
    vals = np.where((special > 0.03) & (special < 0.06), -0.0, vals)
    vals = np.where((special > 0.06) & (special < 0.07), np.inf, vals)
    vals = np.where((special > 0.07) & (special < 0.08), -np.inf, vals)
    vals = np.where(special > 0.5, vals + rng.normal(0, 1, N), vals)
    ints = rng.integers(-50, 50, N).astype(np.int64)
    return {"float": vals, "int": ints, "valid": valid, "gid": gid}


FUNCS = [(f, frac, desc)
         for f in ("PERCENTILE_CONT", "PERCENTILE_DISC")
         for frac in (0.0, 0.25, 0.5, 0.9, 1.0) for desc in (False, True)] \
    + [("MODE", None, False), ("MODE", None, True)]


def _run(device, func, frac, desc, vals, valid, gid):
    agg = types.SimpleNamespace(func=getattr(lp.AggFunc, func),
                                param=(frac, desc))
    ex = QueryExecutor(device)
    out, ok = ex._grouped_percentile(
        agg, torch.from_numpy(vals).to(device),
        torch.from_numpy(valid).to(device), torch.from_numpy(gid).to(device),
        LIVE, N, OUT_CAP, {})
    return out.cpu(), ok.cpu()


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("func,frac,desc", FUNCS)
def test_grouped_percentile_card_equals_cpu(planes, kind, func, frac, desc):
    vals = planes[kind]
    want, want_ok = _run("cpu", func, frac, desc, vals, planes["valid"],
                         planes["gid"])
    got, got_ok = _run("cuda", func, frac, desc, vals, planes["valid"],
                       planes["gid"])
    assert torch.equal(got_ok, want_ok)
    assert bool(want_ok[:999].all()) and not bool(want_ok[999:].any())
    if got.is_floating_point():
        got, want = got.view(torch.int64), want.view(torch.int64)
    assert torch.equal(got[got_ok], want[want_ok])


def test_sort_by_group_value_card_equals_cpu(planes):
    ok = torch.from_numpy(planes["valid"])
    ok[LIVE:] = False
    args = (torch.from_numpy(planes["float"]), ok,
            torch.from_numpy(planes["gid"]))
    want = K.sort_by_group_value(*args, OUT_CAP)
    got = K.sort_by_group_value(*(a.cuda() for a in args), OUT_CAP)
    for g, w in zip(got, want):
        g = g.cpu()
        if g.is_floating_point():
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def tables():
    return data.generate(1 << 14)


@pytest.fixture(scope="module")
def cpu_rows(tables):
    s = Session(device="cpu")
    data.register(s, tables)
    return {q: s.sql(text).to_pylist() for q, text in ordered.QUERIES.items()}


@pytest.mark.parametrize("q", list(ordered.QUERIES))
def test_statement_on_card_equals_cpu(tables, cpu_rows, q):
    s = Session(device="cuda")
    data.register(s, tables)
    want = ordered.run(q, tables)
    oracle.compare(cpu_rows[q], want)
    text = ordered.QUERIES[q]
    for _ in range(3):  # the first run, then warm runs
        oracle.compare(s.sql(text).to_pylist(), cpu_rows[q])
    s.executor._compiled = False
    oracle.compare(s.sql(text).to_pylist(), cpu_rows[q])
