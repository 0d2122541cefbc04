"""The ordered-set, STRING_AGG, ARRAY_AGG/UNNEST, LIST-function and WITH
RECURSIVE statements of `query_engine_tpu_torch.tpch.ordered` (O1-O6) at
`benchmarks/tpch_mini.build(1 << 11)`:

* each statement gives the JAX Session's rows, in order, through the
  port's Session on the CPU: compiled, with QE_COMPILED=0, and with the
  pipeline admitting nodes as on CUDA (`_graphs = True`, `_capture`
  stubbed), where an aggregate with an ordered-set, STRING_AGG or ARRAY_AGG
  function or a LIST function is an eager leaf and nothing falls back;
* each statement, with group_agg's card route emulated on the CPU (its
  fixed-point sums, the kernel stood in by `accumulate_plain`), gives its
  numpy oracle's rows, and the statements of `ordered.GROUP_AGG` go
  through the kernel's route;
* each numpy oracle gives the JAX Session's rows, and the comparison
  rejects wrong rows;
* O6 runs 50 rounds.

Integers and strings must match exactly; floats to rtol 1e-9.
"""

import pytest

from benchmarks import tpch_mini
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.tpch import data, oracle, ordered

N_LI = 1 << 11
QUERIES = list(ordered.QUERIES)
# the eager leaves of each statement's program: the node its new form
# makes one (and O3's scalar subquery, whose plan runs before the program)
LEAVES = {"O1": {"HashAggregate"}, "O2": {"HashAggregate"},
          "O3": {"HashAggregate", "subplan"}, "O4a": {"HashAggregate"},
          "O4b": {"HashAggregate"}, "O5a": {"Projection"},
          "O5b": {"HashAggregate"}}


@pytest.fixture(scope="module")
def jax_rows():
    js, _ = tpch_mini.build(N_LI)
    return {q: js.sql(text).to_pylist() for q, text in ordered.QUERIES.items()}


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
    got = s.sql(ordered.QUERIES[q]).to_pylist()
    oracle.compare(got, jax_rows[q])
    assert got
    pipe = s.executor.pipeline
    if mode == "QE_COMPILED=0":
        assert pipe.stats["compiles"] == 0
        return
    assert pipe.stats["fallbacks"] == 0, pipe.stats
    if q in LEAVES:
        assert set(pipe.leaf_kinds) == LEAVES[q], pipe.leaf_kinds
    if q in ordered.HOST_FINALIZED:
        assert s.executor.host_ms[ordered.HOST_FINALIZED[q]] > 0


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
    got = s.sql(ordered.QUERIES[q]).to_pylist()
    ordered.compare(q, got, ordered.run(q, host_tables))
    assert launches or q not in ordered.GROUP_AGG


@pytest.mark.parametrize("q", QUERIES)
def test_oracle_matches_jax(jax_rows, host_tables, q):
    want = jax_rows[q]
    ordered.compare(q, ordered.run(q, host_tables), want)
    assert want


def test_o6_rounds_and_o2_ties(host_tables):
    """O6's recursion runs RECURSION_DEPTH rounds; O2 has a group whose
    ASC and DESC modes differ (a tie the rule decides)."""
    s = _session(host_tables, "compiled")
    s.sql(ordered.QUERIES["O6"]).to_pylist()
    assert s.recursion == {"iterations": ordered.RECURSION_DEPTH,
                           "dedup_ms": 0.0}
    assert any(m != md for _, m, md in ordered.run("O2", host_tables))


@pytest.mark.parametrize("q,row,col,wrong", [
    ("O1", 0, 2, lambda v: v * (1 + 1e-6)),  # a MEDIAN
    ("O1", 1, 4, lambda v: v + 0.01),         # a DISC DESC one value off
    ("O2", 0, 1, lambda v: v + 1),            # a MODE
    ("O3", 0, 1, lambda v: v * (1 + 1e-6)),   # a median in HAVING
    ("O4b", 0, 1, lambda v: v[:-1]),          # a STRING_AGG one char short
    ("O5a", 3, 2, lambda v: v + "x"),         # an UNNEST element
    ("O5b", 0, 1, lambda v: v + 1),           # a word's count
    ("O6", 7, 2, lambda v: v * (1 + 1e-6)),   # a SUM over the join
])
def test_compare_rejects_wrong_rows(host_tables, q, row, col, wrong):
    want = ordered.run(q, host_tables)
    bad = [list(r) for r in want]
    bad[row][col] = wrong(bad[row][col])
    with pytest.raises(AssertionError):
        ordered.compare(q, [tuple(r) for r in bad], want)
    with pytest.raises(AssertionError):
        ordered.compare(q, want[:-1], want)
    assert ordered.compare(q, want, want) == 0.0
