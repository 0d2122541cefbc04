"""The compiled pipeline's differential fuzz, port against reference.

tests/test_fuzz_compiled.py's generator (`gen_query`, its tables through
`make_session`) run through the JAX Session and the port's
`Session(device="cpu")`, both with the compiled pipeline on: rows must be
equal, as multisets where the query does not order them. The reference's
fuzz runs 120 seeds in the slow tier; this file runs a fixed subset in the
fast one: every seed whose query is a join (unique and non-unique side,
INNER and LEFT, residual ON conditions: now compiled, bounded or counted)
or a join under an aggregate, and a spread of the other shapes (filters,
grouped aggregates on computed keys, set operations, windows, subqueries,
grouping sets, CTEs, DISTINCT).

The port reproduces the reference's defects (ROADMAP.md §3) rather than
report them: the cases compare the two packages, not SQL's answer.
"""

import random

import pytest

import test_fuzz_compiled as F
from query_engine_tpu_torch.engine.session import Session

JOINS = [5, 10, 19, 27, 33, 37, 38, 42, 53, 58, 69, 101]
JOIN_AGGS = [24, 26, 68, 84, 95, 106, 118]
OTHERS = [0, 1, 2, 7, 9, 11, 12, 15, 16, 20, 23, 46, 52, 62, 86, 104]
SEEDS = JOINS + JOIN_AGGS + OTHERS


def _port_session():
    """make_session's tables (the same draws) in a port Session."""
    real = F.Session
    F.Session = lambda: Session(device="cpu")
    try:
        return F.make_session(True)
    finally:
        F.Session = real


@pytest.fixture(scope="module")
def sessions():
    return F.make_session(True), _port_session()


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_compiled_port_vs_reference(sessions, seed):
    ref, port = sessions
    q, ordered = F.gen_query(random.Random(seed))
    want = ref.sql(q)
    got = port.sql(q)
    assert got.schema.names() == want.schema.names(), q
    rg, rw = got.to_pylist(), want.to_pylist()
    if not ordered:
        rg, rw = sorted(rg, key=F._key), sorted(rw, key=F._key)
    assert rg == rw, q


def test_fuzz_joins_compile(sessions):
    """The subset's joins ran in the port's programs: none was demoted to
    an eager leaf for want of a bounded side (the unique t2, the
    non-unique t3 with a multiplicity stat)."""
    _, port = sessions
    st = port.executor.pipeline.stats
    assert st["joins_inlined"] > 0 and st["joins_demoted"] == 0, st
