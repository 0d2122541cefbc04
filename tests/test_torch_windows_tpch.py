"""The window, DISTINCT, set-operation and CROSS join queries of
`query_engine_tpu_torch.tpch.windows` (W1-W6, D1, S1-S3, X1) at
`benchmarks/tpch_mini.build(1 << 11)`:

* each query gives the JAX Session's rows, in order, through the port's
  Session on the CPU: compiled, with QE_COMPILED=0, and with the pipeline
  admitting nodes as on CUDA (`_graphs = True`, `_capture` stubbed), where
  only S3's string set operations run as eager leaves;
* each numpy oracle gives the JAX Session's rows (floats within the
  oracle's float-sum allowance plus rtol 1e-9);
* the oracles' allowances and comparison reject wrong rows.

Integers, strings and dates must match exactly; floats to rtol 1e-9.
"""

import pytest

from benchmarks import tpch_mini
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import data, oracle, windows

N_LI = 1 << 11
QUERIES = list(windows.QUERIES)


@pytest.fixture(scope="module")
def jax_rows():
    js, _ = tpch_mini.build(N_LI)
    return {q: js.sql(text).to_pylist() for q, text in windows.QUERIES.items()}


@pytest.fixture(scope="module")
def host_tables():
    return data.generate(N_LI)


@pytest.mark.parametrize("mode", ["compiled", "QE_COMPILED=0", "graphs"])
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(jax_rows, host_tables, q, mode):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
    data.register(s, host_tables)
    got = s.sql(windows.QUERIES[q]).to_pylist()
    oracle.compare(got, jax_rows[q], windows.FLOAT_SORT_KEYS.get(q, ()))
    assert got
    pipe = s.executor.pipeline
    if mode == "QE_COMPILED=0":
        assert pipe.stats["compiles"] == 0
        return
    assert pipe.stats["fallbacks"] == 0, pipe.stats
    leaves = set(pipe.leaf_kinds) & {"Window", "Distinct", "SetOp"}
    if mode == "graphs" and q == "S3":
        assert leaves == {"SetOp"}, pipe.leaf_kinds
    else:
        assert not leaves, pipe.leaf_kinds


@pytest.mark.parametrize("q", QUERIES)
def test_oracle_matches_jax(jax_rows, host_tables, q):
    want = jax_rows[q]
    got = windows.run(q, host_tables)
    windows.compare(q, got, want, windows.allowance(q, host_tables))
    assert want


def test_float_window_sums_have_an_allowance(host_tables):
    for q in windows.FLOAT_SUMS:
        atol = windows.allowance(q, host_tables)
        assert atol and all(v > 0 for v in atol.values()), q
    assert windows.allowance("W5", host_tables) == {}  # int64: exact
    # W3's share is a ratio of the window sum: its allowance is the sum's
    # times share / S, far below rtol 1e-9 of any share
    w3 = windows.run("W3", host_tables)
    (c, a), = windows.allowance("W3", host_tables).items()
    assert c == 3 and a < oracle.RTOL * min(abs(r[3]) for r in w3)


def test_compare_rejects_wrong_rows(host_tables):
    want = windows.run("W2", host_tables)
    atol = windows.allowance("W2", host_tables)
    bad = list(want)
    c, d, k, run, rn = bad[5]
    bad[5] = (c, d, k, run + 4 * atol[3] + 1e-6 * abs(run), rn)
    with pytest.raises(AssertionError):
        windows.compare("W2", bad, want, atol)
    with pytest.raises(AssertionError):  # a row missing
        windows.compare("W2", want[:-1], want, atol)
    swapped = [want[1], want[0]] + want[2:]
    with pytest.raises(AssertionError):  # ROW_NUMBER order is exact
        windows.compare("W2", swapped, want, atol)
    assert windows.compare("W2", want, want, atol) == (0.0, 0.0)
    # a share off by 1e-6 of itself: W3's share column takes no absolute
    # allowance of the size of the whole sum's
    want = windows.run("W3", host_tables)
    atol = windows.allowance("W3", host_tables)
    b, k, rev, share = want[0]
    with pytest.raises(AssertionError):
        windows.compare("W3", [(b, k, rev, share * (1 + 1e-6))] + want[1:],
                        want, atol)
