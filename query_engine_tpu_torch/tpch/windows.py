"""Window functions, DISTINCT, set operations and a CROSS join over the TPC-H
tables of `data.generate`, each with a numpy oracle.

The texts follow the shapes of TPC-DS v3.2's window and set-operation
queries, over TPC-H's tables:

  W1  top-N by RANK() per partition (TPC-DS Q44, Q67);
  W2  a cumulative SUM ... ROWS UNBOUNDED PRECEDING, with ROW_NUMBER over
      the same spec (Q51);
  W3  each row's share of its partition's total, over a join and a GROUP
      BY (Q98, Q12, Q20);
  W4  moving averages and extremes over bounded ROWS frames, LAG, LEAD and
      NTILE (Q47, Q57);
  W5  a RANGE offset frame over a date key, in int64 (exact), under a
      GROUP BY;
  W6  FIRST_VALUE, LAST_VALUE, PERCENT_RANK and CUME_DIST;
  D1  SELECT DISTINCT over an int key and two dictionary keys;
  S1  INTERSECT and S2 EXCEPT over distinct customer sets (Q38, Q87);
  S3  UNION over two dictionaries, then UNION ALL;
  X1  a CROSS join.

The positional functions (ROW_NUMBER, FIRST/LAST_VALUE, LAG/LEAD, NTILE)
order by keys that are unique within a partition, so no answer depends on
how ties are broken. Two behaviours of the parser, which the JAX package
shares, shape the set operations' texts: an ORDER BY written after
`a INTERSECT b` binds to the right-hand SELECT, so S1 and S2 order an
outer SELECT over the set operation; and in a chain `a UNION b UNION ALL c`
the last operator replaces the first (the result is `a UNION ALL c`), so S3
puts its UNION in a derived table.

Each oracle computes its rows from the host tables with numpy alone (a
stable `np.lexsort`, `searchsorted`, `bincount`), in the form
`ColumnBatch.to_pylist()` gives them. A float window SUM in the engine is
a prefix difference, P[hi] - P[lo - 1] of one cumsum over the whole sorted
plane, while the oracles sum each frame by itself; `compare` allows an
output column that such a sum reaches `8 * 2^-53 * sum(|x|)` over the
summed plane, times the share of that error the column carries
(`ALLOWANCE_OF`), plus rtol 1e-9; every other float cell rtol 1e-9 alone.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from query_engine_tpu_torch.tpch.data import HostTable, days
from query_engine_tpu_torch.tpch.oracle import RTOL, _T, _close, _date

QUERIES = {
    "W1": (
        "SELECT l_suppkey, l_orderkey, l_partkey, l_extendedprice, rk "
        "FROM (SELECT l_suppkey, l_orderkey, l_partkey, l_extendedprice, "
        "RANK() OVER (PARTITION BY l_suppkey ORDER BY l_extendedprice DESC) "
        "AS rk FROM lineitem) t "
        "WHERE rk <= 3 ORDER BY l_suppkey, rk, l_orderkey, l_partkey"
    ),
    "W2": (
        "SELECT * FROM (SELECT o_custkey, o_orderdate, o_orderkey, "
        "SUM(o_totalprice) OVER (PARTITION BY o_custkey "
        "ORDER BY o_orderdate, o_orderkey "
        "ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS run, "
        "ROW_NUMBER() OVER (PARTITION BY o_custkey "
        "ORDER BY o_orderdate, o_orderkey) AS rn FROM orders) t "
        "WHERE o_custkey < 3000 ORDER BY o_custkey, rn"
    ),
    "W3": (
        "SELECT p_brand, p_partkey, rev, "
        "rev * 100 / SUM(rev) OVER (PARTITION BY p_brand) AS share "
        "FROM (SELECT p_brand, p_partkey, SUM(l_extendedprice) AS rev "
        "FROM lineitem JOIN part ON l_partkey = p_partkey "
        "WHERE l_shipdate >= DATE '1995-01-01' "
        "GROUP BY p_brand, p_partkey) t "
        "ORDER BY p_brand, share DESC, p_partkey"
    ),
    "W4": (
        "SELECT o_orderdate, rev, "
        "AVG(rev) OVER (ORDER BY o_orderdate "
        "ROWS BETWEEN 6 PRECEDING AND CURRENT ROW) AS ma7, "
        "MAX(rev) OVER (ORDER BY o_orderdate "
        "ROWS BETWEEN 6 PRECEDING AND CURRENT ROW) AS mx7, "
        "MIN(rev) OVER (ORDER BY o_orderdate "
        "ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS mn7, "
        "LAG(rev, 1) OVER (ORDER BY o_orderdate) AS prev, "
        "LEAD(rev, 7) OVER (ORDER BY o_orderdate) AS next7, "
        "NTILE(4) OVER (ORDER BY rev) AS q "
        "FROM (SELECT o_orderdate, SUM(o_totalprice) AS rev FROM orders "
        "GROUP BY o_orderdate) t ORDER BY o_orderdate"
    ),
    "W5": (
        "SELECT l_suppkey, MAX(q30), SUM(q30) FROM (SELECT l_suppkey, "
        "SUM(l_quantity) OVER (PARTITION BY l_suppkey ORDER BY l_shipdate "
        "RANGE BETWEEN 30 PRECEDING AND CURRENT ROW) AS q30 FROM lineitem) t "
        "GROUP BY l_suppkey ORDER BY l_suppkey"
    ),
    "W6": (
        "SELECT * FROM (SELECT l_orderkey, l_partkey, l_suppkey, "
        "FIRST_VALUE(l_partkey) OVER (PARTITION BY l_orderkey "
        "ORDER BY l_partkey, l_suppkey) AS fv, "
        "LAST_VALUE(l_partkey) OVER (PARTITION BY l_orderkey "
        "ORDER BY l_partkey, l_suppkey "
        "ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS lv, "
        "PERCENT_RANK() OVER (PARTITION BY l_orderkey ORDER BY l_quantity) "
        "AS pr, "
        "CUME_DIST() OVER (PARTITION BY l_orderkey ORDER BY l_quantity) "
        "AS cd FROM lineitem) t "
        "WHERE l_orderkey < 10000 ORDER BY l_orderkey, l_partkey, l_suppkey"
    ),
    "D1": (
        "SELECT DISTINCT l_suppkey, l_returnflag, l_linestatus FROM lineitem "
        "ORDER BY l_suppkey, l_returnflag, l_linestatus"
    ),
    "S1": (
        "SELECT o_custkey FROM (SELECT o_custkey FROM orders "
        "WHERE o_orderdate < DATE '1994-01-01' INTERSECT "
        "SELECT o_custkey FROM orders WHERE o_orderdate >= DATE '1997-01-01'"
        ") t ORDER BY o_custkey"
    ),
    "S2": (
        "SELECT c_custkey FROM (SELECT c_custkey FROM customer EXCEPT "
        "SELECT o_custkey FROM orders) t ORDER BY c_custkey"
    ),
    "S3": (
        "SELECT n_name FROM (SELECT n_name FROM nation UNION "
        "SELECT r_name FROM region) t "
        "UNION ALL SELECT s_name FROM supplier WHERE s_suppkey < 3"
    ),
    "X1": (
        "SELECT n_name, r_name FROM nation CROSS JOIN region "
        "ORDER BY n_name, r_name"
    ),
}

# queries whose GROUP BY runs the group_agg kernel on the card
GROUP_AGG = ("W3", "W5")
# queries with a float window SUM or AVG (a prefix difference)
FLOAT_SUMS = ("W2", "W3", "W4")
# float ORDER BY keys (column positions): rows whose keys agree within
# rtol may come in either order
FLOAT_SORT_KEYS = {"W3": (3,)}


def _segments(*keys_sorted):
    """Start flags of the runs of equal key tuples over sorted planes."""
    n = len(keys_sorted[0])
    start = np.zeros(n, dtype=bool)
    if n:
        start[0] = True
    for k in keys_sorted:
        start[1:] |= k[1:] != k[:-1]
    return start


def _run_start(start: np.ndarray) -> np.ndarray:
    """The position of each row's run start."""
    return np.maximum.accumulate(np.where(start, np.arange(len(start)), 0))


def _run_end(start: np.ndarray) -> np.ndarray:
    """The position of each row's run end."""
    n = len(start)
    end = np.append(start[1:], True)
    idx = np.where(end, np.arange(n), n - 1)
    return np.minimum.accumulate(idx[::-1])[::-1]


def w1(T):
    li = T["lineitem"]
    price, supp = li.l_extendedprice, li.l_suppkey
    # RANK() <= 3 keeps a row whose price is at least its supplier's third
    # largest. The least of the supplier's maxima over three disjoint row
    # sets is at most that (three rows reach it), so the rows below it go
    # before the sort: a row that costs more than a kept row is kept too,
    # so the ranks among the rest are the ranks over all rows
    n_supp = int(supp.max()) + 1 if len(supp) else 0
    bound = np.full(n_supp, np.inf)
    for j in range(3):
        m = np.full(n_supp, -np.inf)
        np.maximum.at(m, supp[j::3], price[j::3])
        bound = np.minimum(bound, m)
    cand = np.flatnonzero(price >= bound[supp])
    order = cand[np.lexsort((-price[cand], supp[cand]))]
    s, p = supp[order], price[order]
    seg = _segments(s)
    rank = _run_start(_segments(s, p)) - _run_start(seg) + 1
    keep = rank <= 3
    rows = order[keep]
    rk = rank[keep]
    out = np.lexsort((li.l_partkey[rows], li.l_orderkey[rows], rk,
                      li.l_suppkey[rows]))
    return [(int(li.l_suppkey[r]), int(li.l_orderkey[r]),
             int(li.l_partkey[r]), float(price[r]), int(k))
            for r, k in zip(rows[out], rk[out])]


def w2(T):
    o = T["orders"]
    m = np.nonzero(o.o_custkey < 3000)[0]  # the partition key: same frames
    order = m[np.lexsort((o.o_orderkey[m], o.o_orderdate[m],
                          o.o_custkey[m]))]
    cust = o.o_custkey[order]
    price = o.o_totalprice[order]
    bounds = np.flatnonzero(_segments(cust)).tolist() + [len(order)]
    run = np.empty(len(order))
    rn = np.empty(len(order), dtype=np.int64)
    for a, b in zip(bounds[:-1], bounds[1:]):  # each partition by itself
        run[a:b] = np.cumsum(price[a:b])
        rn[a:b] = np.arange(1, b - a + 1)
    return [(int(c), _date(d), int(k), float(r), int(n))
            for c, d, k, r, n in zip(cust, o.o_orderdate[order],
                                     o.o_orderkey[order], run, rn)]


def _w3_rev(T):
    li, pt = T["lineitem"], T["part"]
    m = li.l_shipdate >= days(1995, 1, 1)
    rev = np.bincount(li.l_partkey[m], weights=li.l_extendedprice[m],
                      minlength=pt.n)
    seen = np.bincount(li.l_partkey[m], minlength=pt.n) > 0
    return rev, seen


def w3(T):
    pt = T["part"]
    rev, seen = _w3_rev(T)
    parts = np.flatnonzero(seen)
    brand = pt.p_brand[parts]
    total = np.bincount(brand, weights=rev[parts],
                        minlength=len(pt._t.dicts["p_brand"]))
    share = rev[parts] * 100 / total[brand]
    order = np.lexsort((parts, -share, brand))
    names = pt.text("p_brand", brand[order])
    return [(b, int(k), float(r), float(s))
            for b, k, r, s in zip(names, parts[order], rev[parts][order],
                                  share[order])]


def _w4_rev(T):
    o = T["orders"]
    dates, inv = np.unique(o.o_orderdate, return_inverse=True)
    return dates, np.bincount(inv, weights=o.o_totalprice)


def w4(T):
    dates, rev = _w4_rev(T)
    n = len(dates)
    rows = []
    by_rev = np.argsort(rev, kind="stable")
    tile = np.empty(n, dtype=np.int64)
    q, r = divmod(n, 4)  # PG NTILE: the first r tiles get q + 1 rows
    sizes = [q + 1] * r + [q] * (4 - r)
    tile[by_rev] = np.repeat(np.arange(1, 5), sizes)
    for i in range(n):
        last7 = rev[max(i - 6, 0):i + 1]
        around = rev[max(i - 3, 0):i + 4]
        rows.append((
            _date(dates[i]), float(rev[i]), float(math.fsum(last7)
                                                   / len(last7)),
            float(last7.max()), float(around.min()),
            float(rev[i - 1]) if i >= 1 else None,
            float(rev[i + 7]) if i + 7 < n else None,
            int(tile[i]),
        ))
    return rows


def w5(T):
    li = T["lineitem"]
    # one sort of (supplier, ship date, quantity) packed in a word: a
    # row's 30-day RANGE frame is a run of its supplier's sorted dates
    ship = li.l_shipdate.astype(np.int64)
    qty = li.l_quantity.astype(np.int64)
    assert not len(ship) or (30 <= ship.min() and ship.max() < 1 << 22
                             and 0 <= qty.min() and qty.max() < 1 << 8)
    key = np.sort((li.l_suppkey.astype(np.int64) << 30) | (ship << 8) | qty)
    s, day = key >> 30, key >> 8  # day: (supplier, date)
    c = np.concatenate([[0], np.cumsum(key & 255)])
    lo = np.searchsorted(day, day - 30, side="left")
    hi = np.searchsorted(day, day, side="right")  # peers included
    q30 = c[hi] - c[lo]
    starts = np.flatnonzero(_segments(s))
    if not len(starts):
        return []
    return [(int(k), int(m), int(t)) for k, m, t in zip(
        s[starts], np.maximum.reduceat(q30, starts),
        np.add.reduceat(q30, starts))]


def w6(T):
    li = T["lineitem"]
    m = np.nonzero(li.l_orderkey < 10000)[0]
    ok, pk, sk, qty = (li.l_orderkey[m], li.l_partkey[m], li.l_suppkey[m],
                       li.l_quantity[m])
    by_q = np.lexsort((qty, ok))
    seg = _segments(ok[by_q])
    start, end = _run_start(seg), _run_end(seg)
    count = (end - start + 1).astype(np.float64)
    peers = _segments(ok[by_q], qty[by_q])
    rank = _run_start(peers) - start + 1
    pr = np.where(count > 1, (rank - 1) / np.maximum(count - 1, 1), 0.0)
    cd = (_run_end(peers) - start + 1) / count
    pr_row, cd_row = np.empty(len(m)), np.empty(len(m))
    pr_row[by_q], cd_row[by_q] = pr, cd
    order = np.lexsort((sk, pk, ok))
    okeys = ok[order]
    seg2 = _segments(okeys)
    fv = pk[order][_run_start(seg2)]
    lv = pk[order][_run_end(seg2)]
    return [(int(a), int(b), int(c), int(f), int(g), float(p), float(d))
            for a, b, c, f, g, p, d in zip(okeys, pk[order], sk[order], fv, lv,
                                           pr_row[order], cd_row[order])]


def d1(T):
    li = T["lineitem"]
    nrf = len(li._t.dicts["l_returnflag"])
    nls = len(li._t.dicts["l_linestatus"])
    code = (li.l_suppkey * nrf + li.l_returnflag) * nls + li.l_linestatus
    rows = []
    for c in np.unique(code):
        sk, rest = divmod(int(c), nrf * nls)
        rf, ls = divmod(rest, nls)
        rows.append((sk, li.text("l_returnflag", [rf])[0],
                     li.text("l_linestatus", [ls])[0]))
    return rows


def s1(T):
    o = T["orders"]
    early = o.o_custkey[o.o_orderdate < days(1994, 1, 1)]
    late = o.o_custkey[o.o_orderdate >= days(1997, 1, 1)]
    return [(int(k),) for k in np.intersect1d(early, late)]


def s2(T):
    c, o = T["customer"], T["orders"]
    return [(int(k),) for k in np.setdiff1d(c.c_custkey, o.o_custkey)]


def s3(T):
    n, r, s = T["nation"], T["region"], T["supplier"]
    seen, rows = set(), []
    for name in n.text("n_name", n.n_name) + r.text("r_name", r.r_name):
        if name not in seen:  # UNION: the first of each, in input order
            seen.add(name)
            rows.append((name,))
    keep = np.flatnonzero(s.s_suppkey < 3)
    return rows + [(v,) for v in s.text("s_name", s.s_name[keep])]


def x1(T):
    n, r = T["nation"], T["region"]
    pairs = sorted((a, b) for a in n.text("n_name", n.n_name)
                   for b in r.text("r_name", r.r_name))
    return pairs


ORACLES = {"W1": w1, "W2": w2, "W3": w3, "W4": w4, "W5": w5, "W6": w6,
           "D1": d1, "S1": s1, "S2": s2, "S3": s3, "X1": x1}


def _sum_abs(x: np.ndarray) -> float:
    x = np.abs(x[np.isfinite(x)])
    return float(x.sum()) if len(x) else 0.0


def _w3_share_scale(T) -> float:
    """W3's share = rev * 100 / S, S the brand's window SUM: an error e in
    S moves a share by share * e / S, so the share column carries the
    allowance times the largest share / S."""
    rev, seen = _w3_rev(T)
    parts = np.flatnonzero(seen)
    brand = T["part"].p_brand[parts]
    total = np.bincount(brand, weights=rev[parts])[brand]
    return float(np.max(np.abs(rev[parts] * 100 / total ** 2)))


# each query with a float window SUM: sum(|x|) over the plane its cumsum
# runs over, and the output columns its error reaches with the factor each
# carries it by (AVG over at least one row: 1; a share of the sum: share/S)
ALLOWANCE_OF = {
    "W2": lambda T: (_sum_abs(T["orders"].o_totalprice), {3: 1.0}),
    "W3": lambda T: (_sum_abs(_w3_rev(T)[0]), {3: _w3_share_scale(T)}),
    "W4": lambda T: (_sum_abs(_w4_rev(T)[1]), {2: 1.0}),
}


def run(query: str, tables: Dict[str, HostTable]) -> list:
    """The oracle's rows of one query over the tables of data.generate."""
    return ORACLES[query]({k: _T(v) for k, v in tables.items()})


def allowance(query: str, tables: Dict[str, HostTable]
              ) -> Dict[int, float]:
    """The absolute error each output column of `query` may carry from a
    float window sum: 8 ulps of 2^-53 times sum(|x|) over the summed plane,
    times the column's factor (`ALLOWANCE_OF`); {} without a float window
    sum."""
    f = ALLOWANCE_OF.get(query)
    if f is None:
        return {}
    plane, factors = f({k: _T(v) for k, v in tables.items()})
    return {c: 8 * 2.0 ** -53 * plane * k for c, k in factors.items()}


def compare(query: str, got: list, want: list,
            atol: Optional[Dict[int, float]] = None,
            rtol: float = RTOL) -> Tuple[float, float]:
    """Raises AssertionError unless `got` equals `want` row for row:
    integers, strings and dates exactly, a float in column c within
    atol[c] (0 for a column not in atol) + rtol * |want| (NaN equal to
    NaN); rows whose float ORDER BY keys (FLOAT_SORT_KEYS) agree within
    rtol may come in either order. Returns the largest absolute error of a
    cell in a column of atol, and the largest relative error of any float
    cell."""
    atol = atol or {}
    assert len(got) == len(want), (query, len(got), len(want), got[:3],
                                   want[:3])
    keys = FLOAT_SORT_KEYS.get(query, ())

    def close(c, a, b):
        if isinstance(a, float) and isinstance(b, float):
            if math.isnan(a) or math.isnan(b):
                return math.isnan(a) and math.isnan(b)
            return abs(a - b) <= atol.get(c, 0.0) + rtol * abs(b)
        return _close(a, b, rtol)

    def tied(i):
        """Row i, then the rows near it whose float sort keys agree."""
        yield i
        for j in range(max(i - 64, 0), min(i + 65, len(want))):
            if keys and j != i and all(_close(want[j][k], want[i][k], rtol)
                                       for k in keys):
                yield j

    worst_abs = worst_rel = 0.0
    used = [False] * len(want)
    for i, g in enumerate(got):
        for j in tied(i):
            w = want[j]
            if not used[j] and len(g) == len(w) and all(
                    close(c, a, b) for c, (a, b) in enumerate(zip(g, w))):
                used[j] = True
                for c, (a, b) in enumerate(zip(g, w)):
                    if isinstance(a, float) and isinstance(b, float) \
                            and math.isfinite(a) and math.isfinite(b):
                        if c in atol:
                            worst_abs = max(worst_abs, abs(a - b))
                        if b:
                            worst_rel = max(worst_rel, abs(a - b) / abs(b))
                break
        else:
            raise AssertionError(f"{query} row {i}: {g} is not {want[i]}")
    return worst_abs, worst_rel
