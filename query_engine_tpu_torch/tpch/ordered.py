"""Ordered-set aggregates, STRING_AGG, ARRAY_AGG with UNNEST, the LIST
functions and WITH RECURSIVE over the TPC-H tables of `data.generate`,
each with a numpy oracle.

  O1   MEDIAN and PERCENTILE_CONT(0.9) of l_extendedprice (one sort shared
       by both), PERCENTILE_DISC(0.5) of l_discount DESC, COUNT(*) and
       SUM(l_quantity) per (l_returnflag, l_linestatus) under TPC-H Q1's
       date bound;
  O2   MODE() of l_quantity, ASC and DESC, per l_shipmode (ties: the first
       value in the WITHIN GROUP order);
  O3   PERCENTILE_CONT(0.5) of o_totalprice per o_orderpriority over
       orders, with COUNT(*) and AVG, in HAVING (at or above the median of
       all orders, a global MEDIAN in a scalar subquery: the group with
       the largest median always passes) and in ORDER BY;
  O4a  STRING_AGG(n_name, ', ' ORDER BY n_name) per region, nation joined
       to region;
  O4b  STRING_AGG(DISTINCT p_brand, ',' ORDER BY p_brand) and COUNT(*) per
       p_mfgr over part;
  O5a  ARRAY_AGG(n_name ORDER BY n_nationkey) per region, exploded again by
       UNNEST, with each list's ARRAY_LENGTH;
  O5b  the words of p_name (UNNEST(STRING_TO_ARRAY(p_name, ' '))) with
       their count and the largest word count of a name holding them
       (MAX(ARRAY_LENGTH(...)));
  O6   WITH RECURSIVE q(n): 1..50 by UNION ALL, 50 rounds, joined to
       lineitem on l_quantity = q.n, COUNT(*) and SUM(l_extendedprice) per
       n.

Each oracle computes its rows from the host tables with numpy alone, in
the form `ColumnBatch.to_pylist()` gives them. Quantiles come from
`np.sort` per group with PostgreSQL's index rules written out (CONT: the
lerp at frac * (c - 1); DISC: the 1-based ceil(frac * c)-th value, counted
from the other end for DESC); MODE from `np.unique(..., return_counts=True)`
with PG's tie rule; strings from Python joins.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from query_engine_tpu_torch.tpch.data import HostTable, days
from query_engine_tpu_torch.tpch.oracle import RTOL, _T
from query_engine_tpu_torch.tpch.oracle import compare as _compare

Q1_BOUND = "l_shipdate <= DATE '1998-12-01' - INTERVAL '90 days'"
NATION_REGION = "FROM nation JOIN region ON n_regionkey = r_regionkey"
RECURSION_DEPTH = 50

QUERIES = {
    "O1": (
        "SELECT l_returnflag, l_linestatus, "
        "MEDIAN(l_extendedprice) AS med, "
        "PERCENTILE_CONT(0.9) WITHIN GROUP (ORDER BY l_extendedprice) "
        "AS p90, "
        "PERCENTILE_DISC(0.5) WITHIN GROUP (ORDER BY l_discount DESC) "
        "AS d50, COUNT(*) AS n, SUM(l_quantity) AS q "
        f"FROM lineitem WHERE {Q1_BOUND} "
        "GROUP BY l_returnflag, l_linestatus "
        "ORDER BY l_returnflag, l_linestatus"
    ),
    "O2": (
        "SELECT l_shipmode, "
        "MODE() WITHIN GROUP (ORDER BY l_quantity) AS m, "
        "MODE() WITHIN GROUP (ORDER BY l_quantity DESC) AS md "
        "FROM lineitem GROUP BY l_shipmode ORDER BY l_shipmode"
    ),
    "O3": (
        "SELECT o_orderpriority, "
        "PERCENTILE_CONT(0.5) WITHIN GROUP (ORDER BY o_totalprice) AS med, "
        "COUNT(*) AS n, AVG(o_totalprice) AS mean FROM orders "
        "GROUP BY o_orderpriority "
        "HAVING PERCENTILE_CONT(0.5) WITHIN GROUP (ORDER BY o_totalprice) "
        ">= (SELECT MEDIAN(o_totalprice) FROM orders) ORDER BY med DESC"
    ),
    "O4a": (
        "SELECT r_name, STRING_AGG(n_name, ', ' ORDER BY n_name) AS nations "
        f"{NATION_REGION} GROUP BY r_name ORDER BY r_name"
    ),
    "O4b": (
        "SELECT p_mfgr, STRING_AGG(DISTINCT p_brand, ',' ORDER BY p_brand) "
        "AS brands, COUNT(*) AS n FROM part GROUP BY p_mfgr ORDER BY p_mfgr"
    ),
    "O5a": (
        "SELECT d.r_name, ARRAY_LENGTH(d.names) AS k, u.nm FROM "
        "(SELECT r_name, ARRAY_AGG(n_name ORDER BY n_nationkey) AS names "
        f"{NATION_REGION} GROUP BY r_name) d, UNNEST(d.names) u(nm) "
        "ORDER BY d.r_name, u.nm"
    ),
    "O5b": (
        "SELECT u.w, COUNT(*) AS n, "
        "MAX(ARRAY_LENGTH(STRING_TO_ARRAY(p_name, ' '))) AS most "
        "FROM part, UNNEST(STRING_TO_ARRAY(p_name, ' ')) u(w) "
        "GROUP BY u.w ORDER BY u.w"
    ),
    "O6": (
        "WITH RECURSIVE q(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM q "
        f"WHERE n < {RECURSION_DEPTH}) "
        "SELECT q.n, COUNT(*) AS c, SUM(l_extendedprice) AS s "
        "FROM q JOIN lineitem ON l_quantity = q.n "
        "GROUP BY q.n ORDER BY q.n"
    ),
}

# the statements whose COUNT, SUM or AVG runs the group_agg kernel on the
# card (O4b's and O5b's COUNT too, through the same eager aggregate)
GROUP_AGG = ("O1", "O3", "O6")
# the host-finalized statements, by the executor's `host_ms` kind
HOST_FINALIZED = {"O4a": "string_agg", "O4b": "string_agg",
                  "O5a": "array_agg", "O5b": "unnest"}


def _cont(sorted_vals: np.ndarray, frac: float, desc: bool = False) -> float:
    """PERCENTILE_CONT: the lerp at fr * (c - 1), fr = 1 - frac for DESC."""
    fr = 1.0 - frac if desc else frac
    pos = fr * max(len(sorted_vals) - 1, 0)
    lo, hi = math.floor(pos), math.ceil(pos)
    w = pos - lo
    return float(sorted_vals[lo] * (1.0 - w) + sorted_vals[hi] * w)


def _disc(sorted_vals: np.ndarray, frac: float, desc: bool = False):
    """PERCENTILE_DISC: the 1-based ceil(frac * c)-th value in the WITHIN
    GROUP order."""
    c = len(sorted_vals)
    k = min(max(math.ceil(frac * c), 1), c)
    return sorted_vals[c - k] if desc else sorted_vals[k - 1]


def _mode(vals: np.ndarray, desc: bool = False):
    """MODE: the most frequent value; ties to the smallest (ASC) or the
    largest (DESC), the first in the WITHIN GROUP order."""
    uniq, counts = np.unique(vals, return_counts=True)
    tied = uniq[counts == counts.max()]
    return tied.max() if desc else tied.min()


def o1(T):
    li = T["lineitem"]
    m = li.l_shipdate <= days(1998, 9, 2)
    rows = []
    for rf in range(len(li._t.dicts["l_returnflag"])):
        for ls in range(len(li._t.dicts["l_linestatus"])):
            sel = m & (li.l_returnflag == rf) & (li.l_linestatus == ls)
            if not sel.any():
                continue
            price = np.sort(li.l_extendedprice[sel])
            disc = np.sort(li.l_discount[sel])
            rows.append((li.text("l_returnflag", [rf])[0],
                         li.text("l_linestatus", [ls])[0],
                         _cont(price, 0.5), _cont(price, 0.9),
                         float(_disc(disc, 0.5, desc=True)),
                         int(sel.sum()), int(li.l_quantity[sel].sum())))
    return rows


def o2(T):
    li = T["lineitem"]
    rows = []
    for mode in range(len(li._t.dicts["l_shipmode"])):
        q = li.l_quantity[li.l_shipmode == mode]
        if len(q):
            rows.append((li.text("l_shipmode", [mode])[0], int(_mode(q)),
                         int(_mode(q, desc=True))))
    return rows


def o3(T):
    o = T["orders"]
    overall = _cont(np.sort(o.o_totalprice), 0.5)
    rows = []
    for p in range(len(o._t.dicts["o_orderpriority"])):
        price = o.o_totalprice[o.o_orderpriority == p]
        if len(price) == 0:
            continue
        med = _cont(np.sort(price), 0.5)
        if med >= overall:
            rows.append((o.text("o_orderpriority", [p])[0], med,
                         int(len(price)), float(price.mean())))
    return sorted(rows, key=lambda r: -r[1])


def _nations_by_region(T):
    """{r_name: [(n_nationkey, n_name)] in n_nationkey order}."""
    n, r = T["nation"], T["region"]
    out: Dict[str, list] = {}
    for k in range(n.n):
        region = r.text("r_name", [r.r_regionkey[n.n_regionkey[k]]])[0]
        out.setdefault(region, []).append(
            (int(n.n_nationkey[k]), n.text("n_name", [k])[0]))
    return out


def o4a(T):
    return [(region, ", ".join(sorted(name for _, name in nations)))
            for region, nations in sorted(_nations_by_region(T).items())]


def o4b(T):
    p = T["part"]
    rows = []
    for m in range(len(p._t.dicts["p_mfgr"])):
        sel = p.p_mfgr == m
        if sel.any():
            brands = sorted(set(p.text("p_brand", p.p_brand[sel])))
            rows.append((p.text("p_mfgr", [m])[0], ",".join(brands),
                         int(sel.sum())))
    return rows


def o5a(T):
    rows = []
    for region, nations in sorted(_nations_by_region(T).items()):
        names = [name for _, name in sorted(nations)]
        rows += [(region, len(names), name) for name in sorted(names)]
    return rows


def o5b(T):
    p = T["part"]
    names = p._t.dicts["p_name"]
    per_name = np.bincount(p.p_name, minlength=len(names))
    count: Dict[str, int] = {}
    most: Dict[str, int] = {}
    for name, c in zip(names, per_name.tolist()):
        if not c:
            continue
        words = name.split(" ") if name else []
        for w in words:
            count[w] = count.get(w, 0) + c
            most[w] = max(most.get(w, 0), len(words))
    return [(w, count[w], most[w]) for w in sorted(count)]


def o6(T):
    li = T["lineitem"]
    rows = []
    for n in range(1, RECURSION_DEPTH + 1):
        sel = li.l_quantity == n
        if sel.any():
            rows.append((n, int(sel.sum()),
                         float(li.l_extendedprice[sel].sum())))
    return rows


ORACLES = {"O1": o1, "O2": o2, "O3": o3, "O4a": o4a, "O4b": o4b,
           "O5a": o5a, "O5b": o5b, "O6": o6}


def run(query: str, tables: Dict[str, HostTable]) -> list:
    """The oracle's rows of one statement over the tables of
    data.generate."""
    return ORACLES[query]({k: _T(v) for k, v in tables.items()})


def compare(query: str, got: list, want: list, rtol: float = RTOL) -> float:
    """Raises AssertionError unless `got` equals `want` row for row
    (`oracle.compare`: floats within rtol, the rest exactly); returns the
    largest relative error of a float cell."""
    try:
        return _compare(got, want, rtol=rtol)
    except AssertionError as e:
        raise AssertionError(f"{query}: {e}") from None
