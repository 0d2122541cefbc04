"""The compiled pipeline's count->emit programs, bounded-duplication,
outer and residual-outer joins, group-space counting and functional-
dependency key pruning: the port against the JAX package.

Each case is the port's counterpart of a JAX test (named in its
docstring): the same tables and queries through the JAX Session and the
port's `Session(device="cpu")`, twice each (a first and a warm run). Rows
must be equal (integers exactly, floats to rtol 1e-9), and the pipeline
stats that count the paths must equal the reference's: joins counted
through a count program, joins demoted to eager leaves, emit programs
that reused the count program's join sort or grouping, GROUP BY keys
pruned as dependent. A warm run must compile nothing new.

Every case runs with the pipeline as on the CPU ("plain") and with the
CPU stand-in for CUDA graphs ("graphs", tests/torch_graph_stand_in.py):
there programs are captured and replayed, the count program's output
planes are the emit program's inputs, and a warm run must replay both
without a new capture. Nodes that build a host table (a LIKE) are eager
leaves there, as on the card.
"""

import math
import os

import numpy as np
import pytest

from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session
from torch_graph_stand_in import stand_in_graphs

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
)
MODES = ["plain", "graphs"]
# the stats held equal to the reference's
PATH_STATS = ("joins_counted", "joins_demoted", "join_sorts_reused",
              "group_sorts_reused", "fd_pruned_keys")


def _same_rows(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert a is not None and b is not None, (g, w)
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b, (g, w)


def _sorted(rows):
    return sorted(rows, key=repr)


class Pair:
    """A JAX Session and a port Session over the same tables."""

    def __init__(self, tables, mode, csv=False):
        self.js, self.ts = JSession(), Session(device="cpu")
        self.mode = mode
        if mode == "graphs":
            stand_in_graphs(self.ts.executor.pipeline)
        for s in (self.js, self.ts):
            if csv:
                s.register_csv("employees",
                               os.path.join(DATA, "employees.csv"))
                s.register_csv("departments",
                               os.path.join(DATA, "departments.csv"))
            for name, t in tables.items():
                s.register_table(name, dict(t))

    @property
    def pipe(self):
        return self.ts.executor.pipeline

    def run(self, q, ordered=True, twice=True):
        """Both packages' rows (first and warm run); a warm port run
        compiles nothing and, under the graph stand-in, replays without a
        new capture (unless an eager leaf made new input planes, which
        captures again: not in this slice)."""
        want = self.js.sql(q).to_pylist()
        got = self.ts.sql(q).to_pylist()
        runs = [got]
        if twice:
            st = dict(self.pipe.stats)
            leaves = sum(self.pipe.leaf_kinds.values())
            runs.append(self.ts.sql(q).to_pylist())
            self.js.sql(q)
            after = self.pipe.stats
            assert after["compiles"] == st["compiles"], (q, after)
            if sum(self.pipe.leaf_kinds.values()) == leaves:
                assert after["captures"] == st["captures"], (q, after)
            if self.mode == "graphs" and after["hits"] > st["hits"]:
                assert after["replays"] > st["replays"], (q, after)
        for r in runs:
            if ordered:
                _same_rows(r, want)
            else:
                _same_rows(_sorted(r), _sorted(want))
        return got

    def path_stats(self):
        jst = self.js.executor.pipeline.stats
        return ({k: self.pipe.stats[k] for k in PATH_STATS},
                {k: jst.get(k, 0) for k in PATH_STATS})

    def assert_reference_stats(self):
        got, want = self.path_stats()
        assert got == want, (got, want)


# ---- tests/test_compiled_pipeline.py -----------------------------------

LT = {"k": [1, 1, 2, 2, 3], "a": [10, 11, 20, 21, 30]}
RT = {"k": [1, 2, 2, 9] * 60, "b": list(range(240))}  # dup 120 on k=2
BOUNDED = [
    "SELECT lt.a, rt.b FROM rt JOIN lt ON rt.k = lt.k ORDER BY rt.b, lt.a",
    "SELECT lt.a, rt.b FROM lt RIGHT JOIN rt ON lt.k = rt.k "
    "ORDER BY rt.b, lt.a",
    "SELECT lt.a, rt.b FROM rt LEFT JOIN lt ON rt.k = lt.k "
    "ORDER BY rt.b, lt.a",
    "SELECT lt.a, rt.b FROM lt FULL JOIN rt ON lt.k = rt.k "
    "ORDER BY lt.a, rt.b",
]


@pytest.mark.parametrize("mode", MODES)
def test_bounded_dup_join_emit_capacity(mode):
    """test_compiled_pipeline.py::test_bounded_dup_join_emit_capacity: a
    side with key multiplicity 2 (lt) emits at the static capacity probe
    rows x 2 plus the outer slots, no count program; the bounded LEFT
    outer join's right side is larger than its left."""
    p = Pair({"lt": LT, "rt": RT}, mode)
    for q in BOUNDED:
        p.run(q)
    st = p.pipe.stats
    assert st["compiles"] >= 3 and st["joins_counted"] == 0, st
    assert st["joins_inlined"] >= 4 and not p.pipe.leaf_kinds, st
    p.assert_reference_stats()


BIG = 10**15
HUGE_LT = {"k": [BIG + 1, BIG + 1, BIG + 2, BIG + 2, BIG + 3] * 40,
           "a": list(range(200))}
HUGE_RT = {"k": [BIG + 1, BIG + 2, BIG + 2, BIG + 9] * 60,
           "b": list(range(240))}
COUNTED = [
    "SELECT lt.a, rt.b FROM rt JOIN lt ON rt.k = lt.k ORDER BY rt.b, lt.a",
    "SELECT lt.a, rt.b FROM lt FULL JOIN rt ON lt.k = rt.k "
    "ORDER BY lt.a, rt.b",
]


@pytest.mark.parametrize("mode", MODES)
def test_counted_join_reuses_count_programs_sort(mode):
    """test_compiled_pipeline.py::test_counted_join_reuses_count_programs_
    sort: both sides heavily duplicated on huge-range keys (no direct
    ranks, no multiplicity bound): a count program sizes the join, and the
    emit program takes its sorted space and skips the joint sort. Steady
    state: two programs a query, one host read between them."""
    p = Pair({"lt": HUGE_LT, "rt": HUGE_RT}, mode)
    for q in COUNTED:
        p.run(q)
        syncs = p.ts.executor.host_syncs
        p.run(q, twice=False)
        # the count, then the result's row count
        assert p.ts.executor.host_syncs - syncs == 2
    st = p.pipe.stats
    assert st["joins_counted"] >= 2 and st["join_sorts_reused"] >= 2, st
    assert st["compiles"] == 4, st  # a count and an emit program a query
    if mode == "graphs":
        assert st["captures"] == 4, st
    p.assert_reference_stats()


def test_warm_emit_replays_until_its_count_program_captures_again():
    """Under the graph stand-in the emit program reads the count program's
    output planes: warm runs replay both; a table registered anew captures
    the count program again, and then the emit program too (its handed-
    over planes moved), and the rows are the new table's."""
    p = Pair({"lt": HUGE_LT, "rt": HUGE_RT}, "graphs")
    q = COUNTED[0]
    p.run(q)
    st = dict(p.pipe.stats)
    p.run(q, twice=False)
    assert p.pipe.stats["captures"] == st["captures"]
    assert p.pipe.stats["replays"] == st["replays"] + 2
    lt2 = {"k": HUGE_LT["k"][::-1], "a": HUGE_LT["a"]}
    for s in (p.js, p.ts):
        s.register_table("lt", dict(lt2))
    st = dict(p.pipe.stats)
    p.run(q, twice=False)
    assert p.pipe.stats["compiles"] == st["compiles"]
    assert p.pipe.stats["captures"] == st["captures"] + 2


@pytest.mark.parametrize("mode", MODES)
def test_joins_compile_in_segment_not_silently_demoted(mode):
    """test_compiled_pipeline.py::test_joins_compile_in_segment_not_
    silently_demoted: the FK join traces in the program."""
    p = Pair({}, mode, csv=True)
    q = ("SELECT departments.dept_name, COUNT(*) FROM employees "
         "JOIN departments ON employees.dept_id = departments.dept_id "
         "GROUP BY departments.dept_name ORDER BY departments.dept_name")
    p.run(q)
    st = p.pipe.stats
    assert st["joins_inlined"] >= 1 and st["joins_demoted"] == 0, st
    assert "HashJoin" not in p.pipe.leaf_kinds
    p.assert_reference_stats()


def _group_table():
    rng = np.random.default_rng(31)
    n = 4000
    return {
        "a": rng.integers(0, 1000, n).tolist(),
        "f": rng.normal(0, 1, n).round(2).tolist(),
        "v": rng.integers(1, 50, n).tolist(),
    }


GROUP_SPACE = [
    "SELECT a % 13 + a % 7 AS g, SUM(v) AS s, COUNT(*) AS c "
    "FROM t GROUP BY a % 13 + a % 7 ORDER BY g",
    "SELECT f, COUNT(*) AS c FROM t GROUP BY f ORDER BY f LIMIT 20",
    "SELECT f, SUM(v), AVG(v), MIN(a), MAX(a) FROM t WHERE v > 10 "
    "GROUP BY f ORDER BY f",
]


@pytest.mark.parametrize("mode", MODES)
def test_group_space_count_emit_for_unbounded_keys(mode):
    """test_compiled_pipeline.py::test_group_space_count_emit_for_
    unbounded_keys: a computed and a float group key: a count program
    returns the groups, the emit program aggregates at padded(ng) with the
    count program's group ids (no second group sort)."""
    p = Pair({"t": _group_table()}, mode)
    for q in GROUP_SPACE:
        p.run(q)
    st = p.pipe.stats
    assert st["joins_counted"] >= 3 and st["group_sorts_reused"] >= 3, st
    p.assert_reference_stats()


def test_group_space_emit_aggregates_at_the_counted_bucket(monkeypatch):
    """The emit program's group_agg call is sized by the counted groups
    (71 -> 128 slots), not by the 4096-row capacity."""
    from query_engine_tpu_torch.ops import group_agg

    sizes = []
    real = group_agg.grouped_sums_counts_multi

    def spy(items, gid, num_groups):
        sizes.append(num_groups)
        return real(items, gid, num_groups)

    monkeypatch.setattr(group_agg, "grouped_sums_counts_multi", spy)
    p = Pair({"t": _group_table()}, "plain")
    p.run(GROUP_SPACE[0], twice=False)
    assert sizes and max(sizes) == 128, sizes


# ---- tests/test_outer_residual_join.py ----------------------------------

RESIDUAL_SEEDS = [0, 1, 2]
RESIDUAL_QUERIES = [
    "SELECT a.k, a.x, b.y FROM a LEFT JOIN b ON a.k = b.k AND b.y > 50 "
    "ORDER BY a.k, a.x, b.y",
    "SELECT a.k, b.y FROM a RIGHT JOIN b ON a.k = b.k AND a.x % 2 = 0 "
    "ORDER BY b.y, a.k",
    "SELECT a.k, b.y FROM a FULL JOIN b ON a.k = b.k AND a.x < b.y "
    "ORDER BY a.k, b.y",
    "SELECT a.k, b.tag FROM a LEFT JOIN b ON a.k = b.k "
    "AND b.tag LIKE 'x%' ORDER BY a.k, b.tag",
]
# the LIKE residual builds a host table: an eager leaf under graphs
HOST_TABLE_RESIDUAL = RESIDUAL_QUERIES[3]


def _residual_tables(seed):
    rng = np.random.default_rng(seed)
    n, m = 300, 200
    ak = [int(v) if ok else None for v, ok in
          zip(rng.integers(0, 40, n), rng.random(n) > 0.05)]
    a = {"k": ak, "x": [int(v) for v in rng.integers(0, 100, n)]}
    bk = [int(v) if ok else None for v, ok in
          zip(rng.integers(0, 40, m), rng.random(m) > 0.05)]
    b = {"k": bk, "y": [int(v) for v in rng.integers(0, 100, m)],
         "tag": rng.choice(["xa", "xb", "yc", "yd"], m).tolist()}
    return {"a": a, "b": b}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", RESIDUAL_SEEDS)
def test_outer_residual_joins_match_jax(mode, seed):
    """test_outer_residual_join.py::test_pipeline_matches_eager and
    ::test_pipeline_matches_eager_no_order, every query and seed: each
    with its ORDER BY (rows in order) and without it (as multisets: the
    residual outer join's output has holes, so the result is compacted)."""
    p = Pair(_residual_tables(seed), mode)
    for q in RESIDUAL_QUERIES:
        p.run(q)
        p.run(q.split(" ORDER BY")[0], ordered=False)
    st = p.pipe.stats
    if mode == "plain":
        assert st["joins_inlined"] >= 8 and not p.pipe.leaf_kinds, st
        p.assert_reference_stats()
    else:
        # only the LIKE residual's join runs eagerly: a leaf of the ordered
        # query's program, on each of its two runs (without ORDER BY no
        # program is left above it: the executor runs the query)
        assert p.pipe.leaf_kinds == {"HashJoin": 2}, p.pipe.leaf_kinds


@pytest.mark.parametrize("mode", MODES)
def test_residual_outer_no_order_exact_repro(mode):
    """test_outer_residual_join.py::test_residual_outer_no_order_exact_
    repro: residual-failing pairs are not emitted and the NULL-padded
    rows are not dropped when no ORDER BY forces a compaction."""
    p = Pair({"a": {"k": [1, 1, 2, 3], "x": [10, 20, 30, 40]},
              "b": {"k": [1, 1], "y": [5, 100]}}, mode)
    rows = p.run("SELECT a.k, a.x, b.y FROM a LEFT JOIN b "
                 "ON a.k = b.k AND b.y > 50", ordered=False)
    assert _sorted(rows) == [(1, 10, 100), (1, 20, 100), (2, 30, None),
                             (3, 40, None)]
    assert "HashJoin" not in p.pipe.leaf_kinds


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_inlines_outer_residual(mode):
    """test_outer_residual_join.py::test_pipeline_inlines_outer_residual:
    the residual LEFT join traces in the program."""
    p = Pair(_residual_tables(7), mode)
    before = p.pipe.stats["joins_inlined"]
    p.run(RESIDUAL_QUERIES[0])
    assert p.pipe.stats["joins_inlined"] > before
    assert "HashJoin" not in p.pipe.leaf_kinds
    p.assert_reference_stats()


# ---- tests/test_fd_pruning.py --------------------------------------------


def _fd_data(n=3000, seed=5, null_keys=False):
    rng = np.random.default_rng(seed)
    n_ord = 200
    fact = {
        "l_orderkey": rng.integers(0, n_ord, n).tolist(),
        "price": rng.integers(1, 1000, n).tolist(),
    }
    if null_keys:
        for i in range(0, n, 41):
            fact["l_orderkey"][i] = None
    orders = {
        "o_orderkey": list(range(n_ord)),
        "o_date": rng.integers(8000, 9000, n_ord).tolist(),
        "o_prio": rng.integers(0, 5, n_ord).tolist(),
    }
    return fact, orders


def _fd_second_join():
    fact, orders = _fd_data()
    rng = np.random.default_rng(9)
    orders["o_cust"] = rng.integers(0, 40, len(orders["o_orderkey"])).tolist()
    cust = {"c_id": list(range(40)),
            "c_region": rng.integers(0, 4, 40).tolist()}
    return {"fact": fact, "orders": orders, "cust": cust}


def _fd_labels():
    fact, orders = _fd_data()
    orders["o_label"] = [f"label_{i % 17}" for i in orders["o_orderkey"]]
    return {"fact": fact, "orders": orders}


FD_CASES = {
    "q3_shape_inner_join": (
        lambda: dict(zip(("fact", "orders"), _fd_data())),
        "SELECT l.l_orderkey, SUM(l.price) AS rev, o.o_date, o.o_prio "
        "FROM fact l JOIN orders o ON l.l_orderkey = o.o_orderkey "
        "GROUP BY l.l_orderkey, o.o_date, o.o_prio "
        "ORDER BY rev DESC, l.l_orderkey LIMIT 7", True),
    "left_join_probe_side_outer_is_safe": (
        lambda: dict(zip(("fact", "orders"), _fd_data(null_keys=True))),
        "SELECT l.l_orderkey, COUNT(*) AS n, o.o_date "
        "FROM fact l LEFT JOIN orders o ON l.l_orderkey = o.o_orderkey "
        "GROUP BY l.l_orderkey, o.o_date "
        "ORDER BY l.l_orderkey NULLS LAST", True),
    "right_join_unique_side_outer_not_pruned": (
        lambda: dict(zip(("fact", "orders"), _fd_data())),
        "SELECT l.l_orderkey, COUNT(l.price) AS n, o.o_date "
        "FROM fact l RIGHT JOIN orders o ON l.l_orderkey = o.o_orderkey "
        "GROUP BY l.l_orderkey, o.o_date "
        "ORDER BY l.l_orderkey NULLS LAST, o.o_date", False),
    "no_pruning_without_probe_key_in_group": (
        lambda: dict(zip(("fact", "orders"), _fd_data())),
        "SELECT o.o_prio, SUM(l.price) AS rev "
        "FROM fact l JOIN orders o ON l.l_orderkey = o.o_orderkey "
        "GROUP BY o.o_prio ORDER BY o.o_prio", False),
    "pruning_through_second_join": (
        _fd_second_join,
        "SELECT l.l_orderkey, SUM(l.price) AS rev, o.o_date, c.c_region "
        "FROM fact l JOIN orders o ON l.l_orderkey = o.o_orderkey "
        "JOIN cust c ON o.o_cust = c.c_id "
        "GROUP BY l.l_orderkey, o.o_date, c.c_region "
        "ORDER BY rev DESC, l.l_orderkey LIMIT 9", True),
    "string_dependent_key": (
        _fd_labels,
        "SELECT l.l_orderkey, o.o_label, SUM(l.price) AS rev "
        "FROM fact l JOIN orders o ON l.l_orderkey = o.o_orderkey "
        "GROUP BY l.l_orderkey, o.o_label ORDER BY l.l_orderkey", True),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(FD_CASES))
def test_fd_pruning(mode, case):
    """test_fd_pruning.py's six cases: keys that a unique-side join makes
    functions of a kept group key are pruned (and only then), and the rows
    equal the reference's."""
    tables, q, pruned = FD_CASES[case]
    p = Pair(tables(), mode)
    p.run(q)
    assert (p.pipe.stats["fd_pruned_keys"] > 0) == pruned, p.pipe.stats
    p.assert_reference_stats()


def test_memory_guard_counts_static_emits_but_not_fk_joins(monkeypatch):
    """The emit guard (2^26 rows, here lowered to 128): a bounded static
    emit past it is counted instead, a counted size past it demotes the
    join to an eager leaf, and a unique side taking the FK path, which
    allocates no emit, is left alone (the JAX package counts it too; at
    2^28 fact rows it would then demote the main path's join)."""
    from query_engine_tpu_torch.engine import pipeline as P

    monkeypatch.setattr(P, "_MAX_EMIT", 128)
    tables = {
        "f": {"k": [i % 100 for i in range(200)], "v": list(range(200))},
        "u": {"k": list(range(100)), "w": list(range(100))},  # unique
        "d": {"k": [i // 2 for i in range(20)], "w": list(range(20))},
        "e": {"k": [i // 2 for i in range(200)], "w": list(range(200))},
    }
    p = Pair(tables, "plain")
    st = p.pipe.stats

    def run(q, **want):
        before = dict(st)
        p.run(q, twice=False)
        for k, v in want.items():
            assert st[k] - before[k] == v, (q, k, st)

    # f (256 slots) x u: the FK path, not counted
    run("SELECT f.v, u.w FROM f JOIN u ON f.k = u.k ORDER BY f.v",
        joins_counted=0, joins_demoted=0)
    # f x d, multiplicity 2 on both sides: 256 x 2 slots pass the guard, so
    # the join is counted: 40 pairs, an emit at 128
    run("SELECT f.v, d.w FROM f JOIN d ON f.k = d.k ORDER BY f.v, d.w",
        joins_counted=1, joins_demoted=0)
    # f x e: 400 pairs, a bucket of 512 past the guard: an eager leaf.
    # The executor runs that leaf through the pipeline once more (the join
    # alone), which counts it and demotes it again
    run("SELECT f.v, e.w FROM f JOIN e ON f.k = e.k ORDER BY f.v, e.w",
        joins_counted=0, joins_demoted=2)
    assert p.pipe.leaf_kinds == {"HashJoin": 1}, p.pipe.leaf_kinds
