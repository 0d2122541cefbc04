"""A numpy oracle for each of the 22 queries of `queries.py`.

Each oracle computes a query's rows straight from the host tables of
`data.generate`, independently of the engine: every primary key is
`arange`, so a join is a fancy-index lookup (partsupp's two-column key goes
through one `searchsorted`), a GROUP BY is a `bincount` over a dense group
code, and a string predicate is evaluated once per dictionary value. A
subquery is computed once over its whole table (a per-key MIN, SUM or
average, a membership mask) and looked up per row. The rows come in the
form `ColumnBatch.to_pylist()` gives them (str, int, float,
`datetime.date`), ordered by the query's ORDER BY.

`margins(tables)` gives, for the queries that compare a row with an
aggregate (Q11, Q17, Q20, Q22), how close a row came to its threshold.

`compare(got, want, float_keys)` holds an engine's rows against these:
integers, strings and dates exactly, floats at rtol 1e-9; rows whose float
ORDER BY keys agree within that tolerance may come in either order.
"""

from __future__ import annotations

import bisect
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
    # the pairs searched in sorted order: random probes into a large
    # sorted array miss the caches on every step
    by_want = np.argsort(want)
    pos = np.empty(len(want), dtype=np.int64)
    pos[by_want] = np.searchsorted(key[order], want[by_want])
    row = order[np.clip(pos, 0, len(key) - 1)]
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


def _in_region(T, name: str) -> np.ndarray:
    """Per supplier: its nation lies in region `name`."""
    s, n, r = T["supplier"], T["nation"], T["region"]
    return r.is_("r_name", name)[n.n_regionkey[s.s_nationkey]]


def _margin(x: np.ndarray, thr) -> float:
    """Smallest relative distance of a value from its threshold (inf when
    there is none): how close a row came to the other side."""
    x, thr = np.asarray(x, np.float64), np.broadcast_to(
        np.asarray(thr, np.float64), np.shape(x))
    live = thr != 0
    if not live.any():
        return math.inf
    return float(np.min(np.abs(x[live] - thr[live]) / np.abs(thr[live])))


def q2(T):
    p, ps, s, n = (T[x] for x in ("part", "partsupp", "supplier", "nation"))
    eur = _in_region(T, "EUROPE")[ps.ps_suppkey]
    cost = ps.ps_supplycost
    mincost = np.full(p.n, np.inf)
    np.minimum.at(mincost, ps.ps_partkey[eur], cost[eur])
    pk = ps.ps_partkey
    m = eur & (p.p_size[pk] == 15) \
        & p.where("p_type", lambda v: v.endswith("TIN"))[pk] \
        & (cost == mincost[pk])
    sk, pk = ps.ps_suppkey[m], pk[m]
    nat = s.s_nationkey[sk]
    order = np.lexsort((pk, s.s_name[sk], n.n_name[nat], -s.s_acctbal[sk]))
    order = order[:100]
    return [(float(s.s_acctbal[sk[i]]), s.text("s_name", [s.s_name[sk[i]]])[0],
             n.text("n_name", [n.n_name[nat[i]]])[0], int(pk[i]),
             p.text("p_mfgr", [p.p_mfgr[pk[i]]])[0]) for i in order]


def q4(T):
    o, li = T["orders"], T["lineitem"]
    late = np.zeros(o.n, dtype=bool)
    late[li.l_orderkey[li.l_commitdate < li.l_receiptdate]] = True
    m = (o.o_orderdate >= days(1993, 7, 1)) \
        & (o.o_orderdate < days(1993, 10, 1)) & late
    size = len(o._t.dicts["o_orderpriority"])
    cnt = _count(o.o_orderpriority[m], size)
    return [(o.text("o_orderpriority", [g])[0], int(cnt[g]))
            for g in np.nonzero(cnt)[0]]


def _q11_values(T, fraction=0.01):
    ps, s, n = T["partsupp"], T["supplier"], T["nation"]
    m = n.is_("n_name", "NATION07")[s.s_nationkey[ps.ps_suppkey]]
    value = ps.ps_supplycost[m] * ps.ps_availqty[m]
    pk = ps.ps_partkey[m]
    total = _sum(pk, value, T["part"].n)
    groups = np.nonzero(_count(pk, T["part"].n))[0]
    return groups, total[groups], float(value.sum()) * fraction


def q11(T, fraction=0.01):
    groups, total, thr = _q11_values(T, fraction)
    keep = total > thr
    groups, total = groups[keep], total[keep]
    order = np.argsort(-total, kind="stable")
    return [(int(groups[i]), float(total[i])) for i in order]


def _q15_revenue(T):
    li = T["lineitem"]
    m = (li.l_shipdate >= days(1996, 1, 1)) \
        & (li.l_shipdate < days(1996, 4, 1))
    sk = li.l_suppkey[m]
    n = T["supplier"].n
    return _sum(sk, li.l_extendedprice[m] * (1 - li.l_discount[m]), n), \
        _count(sk, n) > 0


def q15(T):
    s = T["supplier"]
    rev, has = _q15_revenue(T)
    if not has.any():
        return []
    top = rev[has].max()
    return [(int(k), s.text("s_name", [s.s_name[k]])[0], float(rev[k]))
            for k in np.nonzero(has & (rev == top))[0]]


def q16(T):
    ps, p, s = T["partsupp"], T["part"], T["supplier"]
    bad = s.where("s_comment", lambda v: re.search("Customer.*Complaints", v)
                  is not None)
    pk = ps.ps_partkey
    m = ~p.is_("p_brand", "Brand#45")[pk] \
        & ~p.where("p_type", lambda v: v.startswith("MEDIUM"))[pk] \
        & np.isin(p.p_size[pk], [1, 4, 7, 10, 14, 19, 23, 36]) \
        & ~bad[ps.ps_suppkey]
    pk, sk = pk[m], ps.ps_suppkey[m]
    code, size, keys = _groups(
        (p.p_brand[pk], len(p._t.dicts["p_brand"])),
        (p.p_type[pk], len(p._t.dicts["p_type"])), (p.p_size[pk], 51))
    # COUNT(DISTINCT ps_suppkey): one count per distinct (group, supplier)
    pairs = np.unique(code * s.n + sk)
    cnt = _count(pairs // s.n, size)
    groups = np.nonzero(cnt)[0]  # in (brand, type, size) order
    groups = groups[np.argsort(-cnt[groups], kind="stable")][:40]
    rows = []
    for g in groups:
        b, t, z = keys(int(g))
        rows.append((p.text("p_brand", [b])[0], p.text("p_type", [t])[0],
                     int(z), int(cnt[g])))
    return rows


def _q17_rows(T):
    li, p = T["lineitem"], T["part"]
    pk = li.l_partkey
    avg = _sum(pk, li.l_quantity.astype(np.float64), p.n) \
        / np.maximum(_count(pk, p.n), 1)
    part = p.is_("p_brand", "Brand#23") & p.is_("p_container", "MED BOX")
    return part[pk], li.l_quantity, 0.2 * avg[pk]


def q17(T):
    part, qty, thr = _q17_rows(T)
    m = part & (qty < thr)
    price = T["lineitem"].l_extendedprice[m]
    return [(float(price.sum()) / 7.0 if len(price) else None,)]


def q18(T):
    c, o, li = T["customer"], T["orders"], T["lineitem"]
    qty = _sum(li.l_orderkey, li.l_quantity.astype(np.float64), o.n)
    big = np.nonzero(qty > 300)[0]
    ck = o.o_custkey[big]
    # o_totalprice DESC, o_orderdate; then the group order (c_name, ...)
    order = np.lexsort((big, ck, c.c_name[ck], o.o_orderdate[big],
                        -o.o_totalprice[big]))[:100]
    return [(c.text("c_name", [c.c_name[ck[i]]])[0], int(ck[i]),
             int(big[i]), _date(o.o_orderdate[big[i]]),
             float(o.o_totalprice[big[i]]), int(qty[big[i]]))
            for i in order]


def _q20_pairs(T):
    """partsupp rows of forest parts with their 1994 shipped quantity
    (None where no such lineitem): (mask, availqty, 0.5 * sum)."""
    ps, p, li = T["partsupp"], T["part"], T["lineitem"]
    forest = p.where("p_name", lambda v: v.startswith("forest"))
    m94 = (li.l_shipdate >= days(1994, 1, 1)) \
        & (li.l_shipdate < days(1995, 1, 1))
    row = _partsupp_rows(ps, li.l_partkey[m94], li.l_suppkey[m94])
    shipped = row >= 0
    n_ps = len(ps.ps_partkey)
    qty = _sum(row[shipped], li.l_quantity[m94][shipped].astype(np.float64),
               n_ps)
    has = _count(row[shipped], n_ps) > 0
    return forest[ps.ps_partkey] & has, ps.ps_availqty, 0.5 * qty


def q20(T):
    s, n, ps = T["supplier"], T["nation"], T["partsupp"]
    m, avail, thr = _q20_pairs(T)
    ok = np.zeros(s.n, dtype=bool)
    ok[ps.ps_suppkey[m & (avail > thr)]] = True
    keep = np.nonzero(ok & n.is_("n_name", "NATION03")[s.s_nationkey])[0]
    rows = [(s.text("s_name", [s.s_name[k]])[0],
             s.text("s_address", [s.s_address[k]])[0]) for k in keep]
    return sorted(rows)


def q21(T):
    s, li, n = T["supplier"], T["lineitem"], T["nation"]
    n_ord = T["orders"].n
    ok, sk = li.l_orderkey, li.l_suppkey
    late = li.l_receiptdate > li.l_commitdate

    def others(rows):
        """Per lineitem: some row of `rows` in its order has another
        supplier (the order's suppliers are not all this one)."""
        lo = np.full(n_ord, np.iinfo(np.int64).max)
        hi = np.full(n_ord, np.iinfo(np.int64).min)
        np.minimum.at(lo, ok[rows], sk[rows])
        np.maximum.at(hi, ok[rows], sk[rows])
        has = _count(ok[rows], n_ord)[ok] > 0
        return has & ((lo[ok] != sk) | (hi[ok] != sk))

    m = late & n.is_("n_name", "NATION04")[s.s_nationkey[sk]] \
        & others(np.ones(li.n, dtype=bool)) & ~others(late)
    cnt = _count(s.s_name[sk[m]], len(s._t.dicts["s_name"]))
    names = np.nonzero(cnt)[0]  # s_name order
    names = names[np.argsort(-cnt[names], kind="stable")][:100]
    return [(s.text("s_name", [g])[0], int(cnt[g])) for g in names]


_Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def _q22_rows(T):
    c, o = T["customer"], T["orders"]
    code = c.where("c_phone", lambda v: v[:2] in _Q22_CODES)
    bal = c.c_acctbal
    pos = code & (bal > 0.0)
    avg = float(bal[pos].sum()) / int(pos.sum()) if pos.any() else None
    no_orders = _count(o.o_custkey, c.n) == 0
    return code & no_orders, bal, avg


def q22(T):
    c = T["customer"]
    m, bal, avg = _q22_rows(T)
    if avg is None:
        return []
    m = m & (bal > avg)
    prefix = np.asarray([v[:2] for v in c._t.dicts["c_phone"]], dtype=object)
    rows = []
    for cc in sorted(set(prefix[c.c_phone[m]])):
        sel = m & (prefix[c.c_phone] == cc)
        rows.append((str(cc), int(sel.sum()), float(bal[sel].sum())))
    return rows


ORACLES: Dict[str, Callable] = {
    "Q1": q1, "Q2": q2, "Q3": q3, "Q4": q4, "Q5": q5, "Q6": q6, "Q7": q7,
    "Q8": q8, "Q9": q9, "Q10": q10, "Q11": q11, "Q12": q12, "Q13": q13,
    "Q14": q14, "Q15": q15, "Q16": q16, "Q17": q17, "Q18": q18, "Q19": q19,
    "Q20": q20, "Q21": q21, "Q22": q22,
}

# the result columns each query orders by that hold floats
FLOAT_SORT_KEYS: Dict[str, Sequence[int]] = {"Q3": (1,), "Q5": (1,),
                                             "Q10": (2,), "Q11": (1,)}


# the margins of `margins` whose threshold is a sum of floats
FLOAT_THRESHOLDS = ("Q11", "Q11_SF1", "Q11_SF10", "Q22")


def margins(tables: Dict[str, HostTable]) -> Dict[str, float]:
    """For each query that compares a row with an aggregate, the smallest
    relative distance between a row's value and its threshold, in the
    oracle's float64 arithmetic: Q11 (a part's value against 1 % of the
    total; Q11_SF1 against 0.01 %, Q11_SF10 against 0.001 %), Q17 (a line's quantity against 0.2 x
    its part's average), Q20
    (availqty against 0.5 x the 1994 shipments) and Q22 (a balance against
    the average). Where the aggregate sums floats (FLOAT_THRESHOLDS), a
    margin near 1e-16 means a row lies within an ulp of its threshold,
    where the card's fixed-point sums may put it on the other side; Q17's
    and Q20's aggregates sum integers, exactly on the card, so even a tie
    (margin 0) resolves as here."""
    T = {k: _T(v) for k, v in tables.items()}
    _, total, thr = _q11_values(T)
    out = {"Q11": _margin(total, thr)}
    _, total, thr = _q11_values(T, 0.0001)
    out["Q11_SF1"] = _margin(total, thr)
    _, total, thr = _q11_values(T, 0.00001)
    out["Q11_SF10"] = _margin(total, thr)
    part, qty, thr17 = _q17_rows(T)
    out["Q17"] = _margin(qty[part], thr17[part])
    m, avail, thr20 = _q20_pairs(T)
    out["Q20"] = _margin(avail[m], thr20[m])
    m, bal, avg = _q22_rows(T)
    out["Q22"] = math.inf if avg is None else _margin(bal[m], avg)
    return out


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


def q11_sf1(tables: Dict[str, HostTable]) -> list:
    """The rows of `queries.Q11_SF1` (FRACTION 0.0001)."""
    return q11({k: _T(v) for k, v in tables.items()}, 0.0001)


def q11_sf10(tables: Dict[str, HostTable]) -> list:
    """The rows of `queries.Q11_SF10` (FRACTION 0.00001)."""
    return q11({k: _T(v) for k, v in tables.items()}, 0.00001)


def _close(a, b, rtol) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return False
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=rtol, abs_tol=0.0)
    return a == b and type(a) is type(b)


def _tied_rows(want: list, float_keys: Sequence[int], rtol: float):
    """i -> the rows j of `want` (in order, i among them) whose float_keys
    all agree with row i's within rtol. A finite float within rtol of a
    lies within 4 * rtol * |a| of it, so the rows by the first key's value
    give a window to test rather than every row; rows whose first key is
    no finite float are tested always."""
    if not float_keys:
        return lambda i: [i]
    k0 = float_keys[0]

    def close(i, j):
        return all(_close(want[j][k], want[i][k], rtol) for k in float_keys)

    if rtol >= 0.25:
        return lambda i: [j for j in range(len(want)) if j == i or close(i, j)]
    finite = [j for j, w in enumerate(want) if isinstance(w[k0], float)
              and math.isfinite(w[k0])]
    odd = sorted(set(range(len(want))) - set(finite))
    finite.sort(key=lambda j: want[j][k0])
    values = [want[j][k0] for j in finite]

    def tied(i):
        a = want[i][k0]
        if not (isinstance(a, float) and math.isfinite(a)):
            return [j for j in range(len(want)) if j == i or close(i, j)]
        lo = bisect.bisect_left(values, a - 4 * rtol * abs(a))
        hi = bisect.bisect_right(values, a + 4 * rtol * abs(a))
        return sorted({i} | {j for j in finite[lo:hi] + odd if close(i, j)})

    return tied


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
    tied_rows = _tied_rows(want, float_keys, rtol)
    for i, g in enumerate(got):
        tied = tied_rows(i)
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
