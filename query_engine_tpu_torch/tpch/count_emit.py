"""Joins and aggregates the compiled pipeline sizes at run time, over the
TPC-H tables of `data.generate`, each with a numpy oracle.

  J1  lineitem JOIN partsupp on the part key: partsupp holds each part
      twice, so its side's key multiplicity is 2 and the join emits at the
      static capacity lineitem x 2 (a bounded-duplication emit);
  J2  lineitem JOIN partsupp on the supplier key: about 40 partsupp rows
      and 400 lineitem rows a supplier, so no side is bounded and a count
      program sizes the join (direct ranks: one bounded integer key);
  J3  J2 on two key pairs (supplier and l_quantity = ps_partkey % 50 + 1):
      no direct ranks, so the count program sorts both sides once
      (join_count_total) and the emit program reuses that sort;
  J4a TPC-H Q13's shape with a numeric residual ON condition, which stays
      in the program: customer LEFT JOIN orders ON c_custkey = o_custkey
      AND o_totalprice > 100000, counted per customer, then the
      distribution;
  J4b a RIGHT and J4c a FULL join of J2's sides, each side filtered so
      that rows stay unmatched on both;
  G1a a GROUP BY on a computed key (l_suppkey % 1000 + l_quantity) and
  G1b one on a float key (l_discount): the groups are counted first and
      the aggregate runs at padded(ng) slots, not at lineitem's capacity;
  F1  TPC-H Q3 and Q10 (`queries.QUERIES`), whose GROUP BY keys the
      pipeline prunes where a unique-side join makes them functions of
      another key; their rows are `oracle.q3`'s and `oracle.q10`'s.

The oracles compute each query's rows from the host tables with numpy
alone (the join sizes by `bincount` per key, never by forming the pairs),
in the form `ColumnBatch.to_pylist()` gives them. `compare` holds an
engine's rows against them: integers and strings exactly, floats to rtol
1e-9.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from query_engine_tpu_torch.tpch.data import HostTable, days
from query_engine_tpu_torch.tpch.oracle import (
    FLOAT_SORT_KEYS as _TPCH_FLOAT_KEYS, RTOL, _T, q3, q10,
)
from query_engine_tpu_torch.tpch.oracle import compare as _compare
from query_engine_tpu_torch.tpch.queries import QUERIES as TPCH

# the two sides of J2-J4c
_LI_SIDE = ("(SELECT l_suppkey, l_quantity FROM lineitem "
            "WHERE l_suppkey < 300) l")
_PS_SIDE = ("(SELECT ps_suppkey, ps_availqty FROM partsupp "
            "WHERE ps_partkey <= 2000) ps")

QUERIES = {
    "J1": (
        "SELECT ps.ps_suppkey, COUNT(*) AS n, SUM(l.l_quantity) AS q "
        "FROM lineitem l JOIN partsupp ps ON l.l_partkey = ps.ps_partkey "
        "WHERE l.l_shipdate < DATE '1994-01-01' "
        "GROUP BY ps.ps_suppkey ORDER BY 3 DESC, 1 LIMIT 20"
    ),
    "J2": (
        "SELECT l.l_returnflag, COUNT(*) AS n, SUM(l.l_extendedprice) AS s "
        "FROM lineitem l JOIN partsupp ps ON l.l_suppkey = ps.ps_suppkey "
        "WHERE ps.ps_partkey <= 2000 "
        "GROUP BY l.l_returnflag ORDER BY 1"
    ),
    "J3": (
        "SELECT l.l_returnflag, COUNT(*) AS n, SUM(l.l_extendedprice) AS s "
        "FROM lineitem l JOIN partsupp ps ON l.l_suppkey = ps.ps_suppkey "
        "AND l.l_quantity = ps.ps_partkey % 50 + 1 "
        "WHERE ps.ps_partkey <= 20000 "
        "GROUP BY l.l_returnflag ORDER BY 1"
    ),
    "J4a": (
        "SELECT c_count, COUNT(*) AS custdist FROM ("
        "SELECT c.c_custkey, COUNT(o.o_orderkey) AS c_count FROM customer c "
        "LEFT JOIN orders o ON c.c_custkey = o.o_custkey "
        "AND o.o_totalprice > 100000 "
        "GROUP BY c.c_custkey) c_orders "
        "GROUP BY c_count ORDER BY custdist DESC, c_count DESC"
    ),
    "J4b": (
        "SELECT COUNT(*) AS n, COUNT(l.l_quantity) AS nl, "
        "SUM(l.l_quantity) AS q, SUM(ps.ps_availqty) AS a "
        f"FROM {_LI_SIDE} RIGHT JOIN {_PS_SIDE} "
        "ON l.l_suppkey = ps.ps_suppkey"
    ),
    "J4c": (
        "SELECT COUNT(*) AS n, COUNT(l.l_quantity) AS nl, "
        "COUNT(ps.ps_availqty) AS np, SUM(l.l_quantity) AS q, "
        "SUM(ps.ps_availqty) AS a "
        f"FROM {_LI_SIDE} FULL JOIN {_PS_SIDE} "
        "ON l.l_suppkey = ps.ps_suppkey"
    ),
    "G1a": (
        "SELECT l_suppkey % 1000 + l_quantity AS g, COUNT(*) AS n, "
        "SUM(l_extendedprice) AS s FROM lineitem "
        "GROUP BY l_suppkey % 1000 + l_quantity ORDER BY g"
    ),
    "G1b": (
        "SELECT l_discount, COUNT(*) AS n, SUM(l_quantity) AS q, "
        "AVG(l_extendedprice) AS a FROM lineitem "
        "GROUP BY l_discount ORDER BY l_discount"
    ),
    "Q3": TPCH["Q3"],
    "Q10": TPCH["Q10"],
}
JOINS = ("J1", "J2", "J3", "J4a", "J4b", "J4c")
# the queries whose join or aggregate must be sized by a count program
COUNTED = ("J2", "J3", "J4b", "J4c", "G1a", "G1b")
# the query whose emit program must reuse the count program's join sort
SORT_REUSED = ("J3",)
# the queries whose emit program must reuse the count program's grouping
GROUPING_REUSED = ("G1a", "G1b")
FD_QUERIES = ("Q3", "Q10")


def _int(x) -> int:
    return int(round(float(x)))


def _flag_groups(li, m, weights_n, weights_s):
    """(l_returnflag, COUNT, SUM) rows over lineitem rows weighted by their
    pair counts, in l_returnflag order, for the flags with pairs."""
    code = li.l_returnflag
    nf = len(li._t.dicts["l_returnflag"])
    n = np.bincount(code[m], weights=weights_n[m], minlength=nf)
    s = np.bincount(code[m], weights=weights_s[m], minlength=nf)
    return [(li.text("l_returnflag", [f])[0], _int(n[f]), float(s[f]))
            for f in range(nf) if n[f] > 0]


def j1(T):
    li, ps = T["lineitem"], T["partsupp"]
    m = li.l_shipdate < days(1994, 1, 1)
    n_part = int(max(li.l_partkey.max(), ps.ps_partkey.max())) + 1
    rows_part = np.bincount(li.l_partkey[m], minlength=n_part)
    qty_part = np.bincount(li.l_partkey[m], weights=li.l_quantity[m],
                           minlength=n_part)
    n_supp = int(ps.ps_suppkey.max()) + 1
    n = np.bincount(ps.ps_suppkey, weights=rows_part[ps.ps_partkey],
                    minlength=n_supp)
    q = np.bincount(ps.ps_suppkey, weights=qty_part[ps.ps_partkey],
                    minlength=n_supp)
    supp = np.nonzero(n)[0]
    order = np.lexsort((supp, -q[supp]))[:20]  # q DESC, then suppkey
    return [(int(supp[i]), _int(n[supp[i]]), _int(q[supp[i]]))
            for i in order]


def _pairs_per_row(key_ps, key_li, size):
    """Per lineitem row, the partsupp rows (filtered) that share its key."""
    return np.bincount(key_ps, minlength=size)[key_li].astype(np.float64)


def j2(T):
    li, ps = T["lineitem"], T["partsupp"]
    pm = ps.ps_partkey <= 2000
    size = int(max(li.l_suppkey.max(), ps.ps_suppkey.max())) + 1
    m_per_row = _pairs_per_row(ps.ps_suppkey[pm], li.l_suppkey, size)
    live = m_per_row > 0
    return _flag_groups(li, live, m_per_row, m_per_row * li.l_extendedprice)


def j3(T):
    li, ps = T["lineitem"], T["partsupp"]
    pm = ps.ps_partkey <= 20000
    width = 64  # l_quantity and ps_partkey % 50 + 1 lie in [1, 50]
    size = (int(max(li.l_suppkey.max(), ps.ps_suppkey.max())) + 1) * width
    key_ps = ps.ps_suppkey[pm] * width + ps.ps_partkey[pm] % 50 + 1
    key_li = li.l_suppkey * width + li.l_quantity
    m_per_row = _pairs_per_row(key_ps, key_li, size)
    live = m_per_row > 0
    return _flag_groups(li, live, m_per_row, m_per_row * li.l_extendedprice)


def j4a(T):
    c, o = T["customer"], T["orders"]
    ok = o.o_totalprice > 100000
    c_count = np.bincount(o.o_custkey[ok], minlength=c.n)[:c.n]
    dist = np.bincount(c_count)
    counts = np.nonzero(dist)[0]
    order = np.lexsort((-counts, -dist[counts]))  # custdist, c_count DESC
    return [(int(counts[i]), int(dist[counts[i]])) for i in order]


def _j4_sides(T):
    li, ps = T["lineitem"], T["partsupp"]
    lm = li.l_suppkey < 300
    pm = ps.ps_partkey <= 2000
    size = int(max(li.l_suppkey.max(), ps.ps_suppkey.max())) + 1
    l_supp, l_qty = li.l_suppkey[lm], li.l_quantity[lm]
    p_supp, p_avail = ps.ps_suppkey[pm], ps.ps_availqty[pm]
    l_cnt = np.bincount(l_supp, minlength=size)
    l_qty_sum = np.bincount(l_supp, weights=l_qty, minlength=size)
    p_cnt = np.bincount(p_supp, minlength=size)
    return l_supp, l_qty, p_supp, p_avail, l_cnt, l_qty_sum, p_cnt


def _sum_or_null(total, rows):
    return _int(total) if rows else None


def j4b(T):
    _, _, p_supp, p_avail, l_cnt, l_qty_sum, _ = _j4_sides(T)
    m = l_cnt[p_supp]  # pairs per partsupp row; 0: a NULL-padded row
    pairs = int(m.sum())
    n = int(np.maximum(m, 1).sum())
    q = l_qty_sum[p_supp].sum()
    a = (p_avail * np.maximum(m, 1)).sum()
    return [(n, pairs, _sum_or_null(q, pairs), _sum_or_null(a, n))]


def j4c(T):
    l_supp, l_qty, p_supp, p_avail, l_cnt, _, p_cnt = _j4_sides(T)
    m_p = l_cnt[p_supp]  # pairs per partsupp row
    m_l = p_cnt[l_supp]  # pairs per lineitem row
    pairs = int(m_p.sum())
    um_p = int((m_p == 0).sum())
    um_l = int((m_l == 0).sum())
    nl, np_ = pairs + um_l, pairs + um_p
    q = (l_qty * np.maximum(m_l, 1)).sum()
    a = (p_avail * np.maximum(m_p, 1)).sum()
    return [(pairs + um_p + um_l, nl, np_, _sum_or_null(q, nl),
             _sum_or_null(a, np_))]


def g1a(T):
    li = T["lineitem"]
    g = li.l_suppkey % 1000 + li.l_quantity
    size = int(g.max()) + 1
    n = np.bincount(g, minlength=size)
    s = np.bincount(g, weights=li.l_extendedprice, minlength=size)
    return [(int(k), int(n[k]), float(s[k])) for k in np.nonzero(n)[0]]


def g1b(T):
    li = T["lineitem"]
    keys, code = np.unique(li.l_discount, return_inverse=True)
    n = np.bincount(code)
    q = np.bincount(code, weights=li.l_quantity)
    s = np.bincount(code, weights=li.l_extendedprice)
    return [(float(k), int(n[i]), _int(q[i]), float(s[i] / n[i]))
            for i, k in enumerate(keys)]


ORACLES = {"J1": j1, "J2": j2, "J3": j3, "J4a": j4a, "J4b": j4b,
           "J4c": j4c, "G1a": g1a, "G1b": g1b, "Q3": q3, "Q10": q10}
# float ORDER BY keys: rows whose keys tie within rtol may swap
FLOAT_SORT_KEYS = {q: _TPCH_FLOAT_KEYS[q] for q in FD_QUERIES}


def run(query: str, tables: Dict[str, HostTable]) -> list:
    """The oracle's rows of one query over the tables of data.generate."""
    return ORACLES[query]({k: _T(v) for k, v in tables.items()})


def compare(query: str, got: list, want: list, rtol: float = RTOL) -> float:
    """Raises AssertionError unless the rows are equal (floats to rtol);
    returns the largest relative error of a float cell."""
    return _compare(got, want, FLOAT_SORT_KEYS.get(query, ()), rtol)
