"""The statistics, GROUPING(), scalar-function, regex and INTERVAL queries of
`query_engine_tpu_torch.tpch.scalar` (F1-F6) at
`benchmarks/tpch_mini.build(1 << 11)`:

* each query gives the JAX Session's rows, in order, through the port's
  Session on the CPU: compiled, with QE_COMPILED=0, and with the pipeline
  admitting nodes as on CUDA (`_graphs = True`, `_capture` stubbed), where
  every query but F4 runs as one program with no eager leaf (two where a
  computed GROUP BY key's groups are counted first) and F4's string
  functions are eager leaves;
* each query, with group_agg's card route emulated on the CPU (its
  fixed-point sums, the kernel stood in by `accumulate_plain`), gives its
  numpy oracle's rows, and the queries of `scalar.GROUP_AGG` go through
  the kernel's route (F4's eager aggregate does too);
* each numpy oracle gives the JAX Session's rows, and the comparison
  rejects wrong rows.

Integers, strings and dates must match exactly; floats to rtol 1e-9.
"""

import pytest

from benchmarks import tpch_mini
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.tpch import data, oracle, queries, scalar

N_LI = 1 << 11
QUERIES = list(scalar.QUERIES)
# GROUP BY a computed key: the groups are counted first, a count and an
# emit program (the JAX package's pipeline compiles the same two)
COUNTED_GROUPS = ("F2", "F4", "F5")


@pytest.fixture(scope="module")
def jax_rows():
    js, _ = tpch_mini.build(N_LI)
    return {q: js.sql(text).to_pylist() for q, text in scalar.QUERIES.items()}


@pytest.fixture(scope="module")
def host_tables():
    return data.generate(N_LI)


def _session(host_tables, mode):
    s = Session(device="cpu")
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
    data.register(s, host_tables)
    return s


@pytest.mark.parametrize("mode", ["compiled", "QE_COMPILED=0", "graphs"])
@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(jax_rows, host_tables, q, mode):
    s = _session(host_tables, mode)
    got = s.sql(scalar.QUERIES[q]).to_pylist()
    oracle.compare(got, jax_rows[q])
    assert got
    pipe = s.executor.pipeline
    if mode == "QE_COMPILED=0":
        assert pipe.stats["compiles"] == 0
        return
    assert pipe.stats["fallbacks"] == 0, pipe.stats
    # under graphs F4's aggregate is an eager leaf: nothing to count
    counted = q in COUNTED_GROUPS and not (
        mode == "graphs" and q in scalar.STRING_FN_QUERIES)
    assert pipe.stats["compiles"] == 1 + counted, pipe.stats
    assert pipe.stats["joins_counted"] == counted, pipe.stats
    if mode == "graphs" and q in scalar.STRING_FN_QUERIES:
        assert set(pipe.leaf_kinds) == {"HashAggregate"}, pipe.leaf_kinds
    else:
        assert not pipe.leaf_kinds, pipe.leaf_kinds


@pytest.mark.parametrize("q", QUERIES)
def test_card_route_matches_oracle(host_tables, q, monkeypatch):
    launches = []
    plain = group_agg.accumulate_plain

    def kernel(items, gid, num_groups):
        launches.append(num_groups)
        return plain(items, gid, num_groups)

    monkeypatch.setattr(group_agg, "on_card", lambda t: True)
    monkeypatch.setattr(group_agg, "accumulate_kernel", kernel)
    s = _session(host_tables, "graphs")
    got = s.sql(scalar.QUERIES[q]).to_pylist()
    # the card's float sums are exact: its F2 rounds a tied mean as exact
    # arithmetic does (group 26 of this data lies 1.5e-13 above a tie)
    scalar.compare(q, got, scalar.run(q, host_tables, exact_sums=True))
    assert launches or q not in scalar.GROUP_AGG


@pytest.mark.parametrize("q", QUERIES)
def test_oracle_matches_jax(jax_rows, host_tables, q):
    want = jax_rows[q]
    scalar.compare(q, scalar.run(q, host_tables), want)
    assert want


def test_f6_is_q1(host_tables):
    """F6 is Q1 with its date bound written as an INTERVAL: the same rows
    as Q1's oracle."""
    assert scalar.run("F6", host_tables) == oracle.run("Q1", host_tables)
    s = _session(host_tables, "compiled")
    oracle.compare(s.sql(scalar.QUERIES["F6"]).to_pylist(),
                   s.sql(queries.QUERIES["Q1"]).to_pylist())


@pytest.mark.parametrize("q,row,col,wrong", [
    ("F1", 0, 3, lambda v: v * (1 + 1e-6)),  # a STDDEV
    ("F1", 2, 5, lambda v: v * (1 + 1e-6)),  # a CORR
    ("F2", 3, 2, lambda v: v + 0.01),        # a rounded AVG one step off
    ("F3", 30, 3, lambda v: v + 1),          # a CUBE subtotal's count
    ("F4", 0, 1, lambda v: v + 1),           # a LENGTH
    ("F5", 1, 4, lambda v: v * (1 + 1e-6)),  # a COALESCE sum
])
def test_compare_rejects_wrong_rows(host_tables, q, row, col, wrong):
    want = scalar.run(q, host_tables)
    bad = [list(r) for r in want]
    bad[row][col] = wrong(bad[row][col])
    with pytest.raises(AssertionError):
        scalar.compare(q, [tuple(r) for r in bad], want)
    with pytest.raises(AssertionError):
        scalar.compare(q, want[:-1], want)
    assert scalar.compare(q, want, want) == 0.0


def test_cancellation_and_round_margin(host_tables):
    """F1's cancellation factors are what the card's error bound needs:
    about 4 for the variances (uniform data) and far more for CORR and the
    regression, whose two columns are drawn independently."""
    fac = scalar.cancellation(host_tables)
    assert len(fac) == len(scalar.run("F1", host_tables))
    for f in fac.values():
        assert 3 < f["sd"] < 6 and 3 < f["vq"] < 6
        assert f["r,b,a"] > 10
    assert 0 <= scalar.f2_round_margin(host_tables) <= 0.5
