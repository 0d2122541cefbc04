"""A numpy oracle for each of the twelve queries of `queries.py`.

Each oracle computes a query's rows straight from the host tables of
`data.generate`, independently of the engine: every primary key is
`arange`, so a join is a fancy-index lookup (partsupp's two-column key goes
through one `searchsorted`), a GROUP BY is a `bincount` over a dense group
code, and a string predicate is evaluated once per dictionary value. The
rows come in the form `ColumnBatch.to_pylist()` gives them (str, int,
float, `datetime.date`), ordered by the query's ORDER BY.

`compare(got, want, float_keys)` holds an engine's rows against these:
integers, strings and dates exactly, floats at rtol 1e-9; rows whose float
ORDER BY keys agree within that tolerance may come in either order.
"""

from __future__ import annotations

import datetime
import math
import re
from typing import Callable, Dict, List, Sequence

import numpy as np

from query_engine_tpu_torch.tpch.data import EPOCH, HostTable, days

RTOL = 1e-9


class _T:
    """Attribute access to one host table's columns; strings as codes."""

    def __init__(self, t: HostTable):
        self._t = t
        self.n = t.num_rows

    def __getattr__(self, name):
        return self._t.columns[name]

    def is_(self, column: str, value: str) -> np.ndarray:
        """column == value, per row."""
        return self._t.columns[column] == self._t.code(column, value)

    def where(self, column: str, pred: Callable[[str], bool]) -> np.ndarray:
        """pred(value), per row: evaluated once per dictionary value."""
        table = np.asarray([bool(pred(v)) for v in self._t.dicts[column]],
                           dtype=bool)
        return table[self._t.columns[column]]

    def text(self, column: str, codes: np.ndarray) -> List[str]:
        return [str(v) for v in self._t.dicts[column][codes]]


def _date(d) -> datetime.date:
    return EPOCH + datetime.timedelta(days=int(d))


def _year(d: np.ndarray) -> np.ndarray:
    return d.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _groups(*codes_and_sizes):
    """Dense group code of a tuple of non-negative int keys, and the
    function mapping a group code back to its key tuple."""
    code = np.zeros(len(codes_and_sizes[0][0]), dtype=np.int64)
    sizes = [size for _, size in codes_and_sizes]
    for c, size in codes_and_sizes:
        code = code * size + c.astype(np.int64)

    def keys(g: int):
        out = []
        for size in reversed(sizes):
            out.append(g % size)
            g //= size
        return out[::-1]

    return code, int(np.prod(sizes)), keys


def _sum(codes, weights, n):
    return np.bincount(codes, weights=weights, minlength=n)


def _count(codes, n):
    return np.bincount(codes, minlength=n)


def _global_sum(x: np.ndarray):
    """SUM over the rows: NULL (None) over no rows."""
    return float(x.sum()) if len(x) else None


def q1(T):
    li = T["lineitem"]
    m = li.l_shipdate <= days(1998, 9, 2)
    nls = len(li._t.dicts["l_linestatus"])
    code, size, keys = _groups((li.l_returnflag[m], len(
        li._t.dicts["l_returnflag"])), (li.l_linestatus[m], nls))
    price, disc, qty = (li.l_extendedprice[m], li.l_discount[m],
                        li.l_quantity[m])
    cnt = _count(code, size)
    sum_qty = _sum(code, qty.astype(np.float64), size)
    sum_qty_i = np.zeros(size, dtype=np.int64)
    np.add.at(sum_qty_i, code, qty)
    sum_base = _sum(code, price, size)
    sum_disc = _sum(code, price * (1 - disc), size)
    sum_d = _sum(code, disc, size)
    rows = []
    for g in np.nonzero(cnt)[0]:
        rf, ls = keys(int(g))
        rows.append((li.text("l_returnflag", [rf])[0],
                     li.text("l_linestatus", [ls])[0], int(sum_qty_i[g]),
                     float(sum_base[g]), float(sum_disc[g]),
                     float(sum_qty[g] / cnt[g]), float(sum_d[g] / cnt[g]),
                     int(cnt[g])))
    return rows


def q3(T):
    c, o, li = T["customer"], T["orders"], T["lineitem"]
    om = c.is_("c_mktsegment", "BUILDING")[o.o_custkey] \
        & (o.o_orderdate < days(1995, 3, 15))
    lm = om[li.l_orderkey] & (li.l_shipdate > days(1995, 3, 15))
    ok = li.l_orderkey[lm]
    rev = _sum(ok, li.l_extendedprice[lm] * (1 - li.l_discount[lm]), o.n)
    groups = np.nonzero(_count(ok, o.n))[0]
    order = groups[np.argsort(-rev[groups], kind="stable")][:10]
    return [(int(k), float(rev[k]), _date(o.o_orderdate[k]),
             int(o.o_shippriority[k])) for k in order]


def q5(T):
    c, o, li, s, n, r = (T[x] for x in ("customer", "orders", "lineitem",
                                        "supplier", "nation", "region"))
    cust = o.o_custkey[li.l_orderkey]
    snat = s.s_nationkey[li.l_suppkey]
    date = o.o_orderdate[li.l_orderkey]
    m = (c.c_nationkey[cust] == snat) \
        & r.is_("r_name", "ASIA")[n.n_regionkey[snat]] \
        & (date >= days(1994, 1, 1)) & (date < days(1995, 1, 1))
    name = n.n_name[snat[m]]
    size = len(n._t.dicts["n_name"])
    rev = _sum(name, li.l_extendedprice[m] * (1 - li.l_discount[m]), size)
    groups = np.nonzero(_count(name, size))[0]
    order = groups[np.argsort(-rev[groups], kind="stable")]
    return [(n.text("n_name", [g])[0], float(rev[g])) for g in order]


def q6(T):
    li = T["lineitem"]
    m = (li.l_shipdate >= days(1994, 1, 1)) \
        & (li.l_shipdate < days(1995, 1, 1)) \
        & (li.l_discount >= 0.05) & (li.l_discount <= 0.07) \
        & (li.l_quantity < 24)
    return [(_global_sum(li.l_extendedprice[m] * li.l_discount[m]),)]


def q7(T):
    c, o, li, s, n = (T[x] for x in ("customer", "orders", "lineitem",
                                     "supplier", "nation"))
    n1 = n.n_name[s.s_nationkey[li.l_suppkey]]
    n2 = n.n_name[c.c_nationkey[o.o_custkey[li.l_orderkey]]]
    a, b = n.n_name[1], n.n_name[2]  # the codes of NATION01, NATION02
    assert n.text("n_name", [a, b]) == ["NATION01", "NATION02"]
    m = (((n1 == a) & (n2 == b)) | ((n1 == b) & (n2 == a))) \
        & (li.l_shipdate >= days(1995, 1, 1)) \
        & (li.l_shipdate <= days(1996, 12, 31))
    year = _year(li.l_shipdate[m])
    size = len(n._t.dicts["n_name"])
    code, gsize, keys = _groups((n1[m], size), (n2[m], size),
                                (year - 1900, 200))
    vol = _sum(code, li.l_extendedprice[m] * (1 - li.l_discount[m]), gsize)
    rows = []
    for g in np.nonzero(_count(code, gsize))[0]:
        k1, k2, y = keys(int(g))
        rows.append((n.text("n_name", [k1])[0], n.text("n_name", [k2])[0],
                     int(y + 1900), float(vol[g])))
    return rows


def q8(T):
    p, li, s, o, c, n, r = (T[x] for x in ("part", "lineitem", "supplier",
                                           "orders", "customer", "nation",
                                           "region"))
    date = o.o_orderdate[li.l_orderkey]
    n1 = c.c_nationkey[o.o_custkey[li.l_orderkey]]
    m = p.is_("p_type", "ECONOMY ANODIZED STEEL")[li.l_partkey] \
        & r.is_("r_name", "AMERICA")[n.n_regionkey[n1]] \
        & (date >= days(1995, 1, 1)) & (date <= days(1996, 12, 31))
    vol = li.l_extendedprice[m] * (1 - li.l_discount[m])
    mine = n.is_("n_name", "NATION05")[s.s_nationkey[li.l_suppkey[m]]]
    year = _year(date[m]) - 1900
    total = _sum(year, vol, 200)
    share = _sum(year, np.where(mine, vol, 0.0), 200)
    return [(int(y + 1900), float(share[y] / total[y]))
            for y in np.nonzero(_count(year, 200))[0]]


def _partsupp_rows(ps, partkey, suppkey):
    """Row of partsupp holding (partkey, suppkey) for each pair, -1 where
    none does."""
    nsupp = int(max(ps.ps_suppkey.max(), suppkey.max())) + 1
    key = ps.ps_partkey * nsupp + ps.ps_suppkey
    order = np.argsort(key, kind="stable")
    want = partkey * nsupp + suppkey
    pos = np.clip(np.searchsorted(key[order], want), 0, len(key) - 1)
    row = order[pos]
    return np.where(key[row] == want, row, -1)


def q9(T):
    p, li, s, ps, o, n = (T[x] for x in ("part", "lineitem", "supplier",
                                         "partsupp", "orders", "nation"))
    psrow = _partsupp_rows(ps, li.l_partkey, li.l_suppkey)
    m = p.where("p_name", lambda v: "green" in v)[li.l_partkey] & (psrow >= 0)
    amount = li.l_extendedprice[m] * (1 - li.l_discount[m]) \
        - ps.ps_supplycost[psrow[m]] * li.l_quantity[m]
    nat = n.n_name[s.s_nationkey[li.l_suppkey[m]]]
    year = _year(o.o_orderdate[li.l_orderkey[m]]) - 1900
    size = len(n._t.dicts["n_name"])
    # nation ascending, year descending
    code, gsize, keys = _groups((nat, size), (199 - year, 200))
    total = _sum(code, amount, gsize)
    rows = []
    for g in np.nonzero(_count(code, gsize))[0]:
        k, y = keys(int(g))
        rows.append((n.text("n_name", [k])[0], int(199 - y + 1900),
                     float(total[g])))
    return rows


def q10(T):
    c, o, li, n = (T[x] for x in ("customer", "orders", "lineitem",
                                  "nation"))
    date = o.o_orderdate[li.l_orderkey]
    m = (date >= days(1993, 10, 1)) & (date < days(1994, 1, 1)) \
        & li.is_("l_returnflag", "R")
    cust = o.o_custkey[li.l_orderkey[m]]
    rev = _sum(cust, li.l_extendedprice[m] * (1 - li.l_discount[m]), c.n)
    groups = np.nonzero(_count(cust, c.n))[0]
    order = groups[np.argsort(-rev[groups], kind="stable")][:20]
    return [(int(k), c.text("c_name", [c.c_name[k]])[0], float(rev[k]),
             float(c.c_acctbal[k]),
             n.text("n_name", [n.n_name[c.c_nationkey[k]]])[0])
            for k in order]


def q12(T):
    o, li = T["orders"], T["lineitem"]
    m = li.where("l_shipmode", lambda v: v in ("MAIL", "SHIP")) \
        & (li.l_commitdate < li.l_receiptdate) \
        & (li.l_shipdate < li.l_commitdate) \
        & (li.l_receiptdate >= days(1994, 1, 1)) \
        & (li.l_receiptdate < days(1995, 1, 1))
    high = o.where("o_orderpriority",
                   lambda v: v in ("1-URGENT", "2-HIGH"))[li.l_orderkey[m]]
    mode = li.l_shipmode[m]
    size = len(li._t.dicts["l_shipmode"])
    hi = _count(mode[high], size)
    lo = _count(mode[~high], size)
    return [(li.text("l_shipmode", [g])[0], int(hi[g]), int(lo[g]))
            for g in np.nonzero(hi + lo)[0]]


def q13(T):
    c, o = T["customer"], T["orders"]
    ok = o.where("o_comment",
                 lambda v: re.search("special.*requests", v) is None)
    c_count = _count(o.o_custkey[ok], c.n)
    dist = np.bincount(c_count)
    counts = np.nonzero(dist)[0]
    order = np.lexsort((-counts, -dist[counts]))  # custdist, c_count DESC
    return [(int(counts[i]), int(dist[counts[i]])) for i in order]


def q14(T):
    li, p = T["lineitem"], T["part"]
    m = (li.l_shipdate >= days(1995, 9, 1)) \
        & (li.l_shipdate < days(1995, 10, 1))
    rev = li.l_extendedprice[m] * (1 - li.l_discount[m])
    promo = p.where("p_type", lambda v: v.startswith("PROMO"))[
        li.l_partkey[m]]
    if not len(rev):
        return [(None,)]
    return [(100.0 * float(np.where(promo, rev, 0.0).sum())
             / float(rev.sum()),)]


def q19(T):
    li, p = T["lineitem"], T["part"]
    pk = li.l_partkey
    air = li.where("l_shipmode", lambda v: v in ("AIR", "REG AIR"))
    qty, size = li.l_quantity, p.p_size[pk]
    m = np.zeros(li.n, dtype=bool)
    for brand, containers, (qlo, qhi), smax in (
            ("Brand#12", ("SM CASE", "SM BOX"), (1, 11), 5),
            ("Brand#23", ("MED BAG", "MED BOX"), (10, 20), 10),
            ("Brand#34", ("LG CASE", "LG BOX"), (20, 30), 15)):
        m |= p.is_("p_brand", brand)[pk] \
            & p.where("p_container", lambda v, cs=containers: v in cs)[pk] \
            & (qty >= qlo) & (qty <= qhi) & (size >= 1) & (size <= smax) & air
    return [(_global_sum(li.l_extendedprice[m] * (1 - li.l_discount[m])),)]


ORACLES: Dict[str, Callable] = {
    "Q1": q1, "Q3": q3, "Q5": q5, "Q6": q6, "Q7": q7, "Q8": q8, "Q9": q9,
    "Q10": q10, "Q12": q12, "Q13": q13, "Q14": q14, "Q19": q19,
}

# the result columns each query orders by that hold floats
FLOAT_SORT_KEYS: Dict[str, Sequence[int]] = {"Q3": (1,), "Q5": (1,),
                                             "Q10": (2,)}


def shifted(tables: Dict[str, HostTable]) -> Dict[str, list]:
    """The rows of `queries.SHIFTED`: Q6 and Q14 a year later."""
    out = {}
    li = _T(tables["lineitem"])
    m = (li.l_shipdate >= days(1995, 1, 1)) \
        & (li.l_shipdate < days(1996, 1, 1)) \
        & (li.l_discount >= 0.05) & (li.l_discount <= 0.07) \
        & (li.l_quantity < 24)
    out["Q6"] = [(_global_sum(li.l_extendedprice[m] * li.l_discount[m]),)]
    p = _T(tables["part"])
    m = (li.l_shipdate >= days(1996, 9, 1)) \
        & (li.l_shipdate < days(1996, 10, 1))
    rev = li.l_extendedprice[m] * (1 - li.l_discount[m])
    promo = p.where("p_type", lambda v: v.startswith("PROMO"))[
        li.l_partkey[m]]
    out["Q14"] = [(100.0 * float(np.where(promo, rev, 0.0).sum())
                   / float(rev.sum()),)] if len(rev) else [(None,)]
    return out


def run(query: str, tables: Dict[str, HostTable]) -> list:
    """The oracle's rows of one query over the tables of data.generate."""
    return ORACLES[query]({k: _T(v) for k, v in tables.items()})


def _close(a, b, rtol) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return False
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=rtol, abs_tol=0.0)
    return a == b and type(a) is type(b)


def compare(got: list, want: list, float_keys: Sequence[int] = (),
            rtol: float = RTOL) -> float:
    """Raises AssertionError unless `got` equals `want` row for row:
    floats within rtol, everything else exactly and of the same type. A row
    may take the place of another whose float ORDER BY keys (`float_keys`,
    column positions) agree with it within rtol. Returns the largest
    relative error of a float cell."""
    assert len(got) == len(want), (len(got), len(want), got[:3], want[:3])
    used = [False] * len(want)
    worst = 0.0
    for i, g in enumerate(got):
        tied = [j for j in range(len(want))
                if j == i or (float_keys and all(
                    _close(want[j][k], want[i][k], rtol) for k in float_keys))]
        for j in sorted(tied, key=lambda j: j != i):
            w = want[j]
            if not used[j] and len(g) == len(w) and all(
                    _close(a, b, rtol) for a, b in zip(g, w)):
                used[j] = True
                for a, b in zip(g, w):
                    if isinstance(a, float) and b and not math.isnan(a):
                        worst = max(worst, abs(a - b) / abs(b))
                break
        else:
            raise AssertionError(f"row {i}: {g} is not {want[i]}")
    return worst
