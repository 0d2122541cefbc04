"""The plain reference of the TPC-H cells: a numpy function a query.

Each function computes a query's rows from the host tables of
`data/tpch.py`, written from the specification's text (section 2.4, the
validation parameters): a key of customer, part or supplier k sits at row
k - 1 and a nation's or region's at row k; an order is found by
`searchsorted` on o_orderkey and a partsupp row on its (part, supplier)
pair; a GROUP BY is a `bincount` over a dense group code, or `np.unique`
over a combined one; a string predicate compares codes, and a LIKE matches
each value of the column's dictionary once. No Python loop runs over rows.

The DECIMAL columns are DOUBLE on the host (the configuration's `assumed`),
each a whole number of cents or of hundredths: every sum is taken exactly in
integers (prices in cents, discounts and taxes in hundredths), and turned
into a float once. Comparisons follow the texts' own arithmetic in float64
(Q11's FRACTION, Q17's 0.2 x AVG, Q20's 0.5 x SUM, Q22's AVG); the nearest
margin to each float threshold is printed, so that a row that falls on the
other side of a threshold in the program can be told from a fault.

`run(name, tables)` gives a query's rows; `ORDER` names the result columns
each query orders by; `MEASURES` names the columns the control computes in
float32, and `ROUND32` the kinds of result values it rounds to float32.
"""

from __future__ import annotations

import datetime
import re
import sys
import threading
import time
from typing import Callable, Dict

import numpy as np

from port_bench.tables import HostTable

EPOCH = datetime.date(1970, 1, 1)
_LO = (1 << 26) - 1


def _day(text: str) -> int:
    return (datetime.date.fromisoformat(text) - EPOCH).days


def _date(days) -> datetime.date:
    return EPOCH + datetime.timedelta(days=int(days))


def _years(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _hundredths(x: np.ndarray) -> np.ndarray:
    """A DECIMAL(15,2) column as exact int64 hundredths."""
    return np.rint(np.asarray(x, dtype=np.float64) * 100).astype(np.int64)


def _sums(idx: np.ndarray, values: np.ndarray, size: int) -> np.ndarray:
    """Exact int64 sums of int64 values by group: bincount's float64 sums
    of the values' low 26 bits and of the rest, each exact."""
    values = np.asarray(values, dtype=np.int64)
    if not len(values) or int(np.abs(values).max()) * len(values) < 2 ** 53:
        # no partial sum can pass 2^53: one float64 bincount is exact
        return np.bincount(idx, weights=values.astype(np.float64),
                           minlength=size).astype(np.int64)
    lo = np.bincount(idx, weights=(values & _LO).astype(np.float64),
                     minlength=size)
    hi = np.bincount(idx, weights=(values >> 26).astype(np.float64),
                     minlength=size)
    if len(idx) and (np.abs(hi).max() * 2 ** 26 >= 2 ** 62
                     or lo.max() >= 2 ** 53):
        raise OverflowError("a sum leaves int64")
    return hi.astype(np.int64) * (1 << 26) + lo.astype(np.int64)


def _total(values: np.ndarray) -> int:
    return int(_sums(np.zeros(len(values), dtype=np.int64), values, 1)[0])


def _like_regex(pattern: str):
    out = "".join(".*" if c == "%" else "." if c == "_" else re.escape(c)
                  for c in pattern)
    return re.compile(out, re.DOTALL)


def _log(msg: str) -> None:
    print(f"[reference] {msg}", file=sys.stderr, flush=True)


class _T:
    """Attribute access to one host table's columns; strings as codes."""

    def __init__(self, t: HostTable):
        self._t = t
        self.n = t.num_rows

    def __getattr__(self, name):
        return self._t.columns[name]

    def code(self, column: str, value: str) -> int:
        return self._t.code(column, value)

    def is_(self, column: str, value: str) -> np.ndarray:
        return self._t.columns[column] == self.code(column, value)

    def text(self, column: str, code) -> str:
        return str(self._t.dicts[column][int(code)])

    def texts(self, column: str) -> np.ndarray:
        return self._t.dicts[column]

    def like(self, column: str, pattern: str) -> np.ndarray:
        """The rows whose value matches: each dictionary value once."""
        match = _like_regex(pattern).fullmatch
        d = self._t.dicts[column]
        table = np.fromiter(map(bool, map(match, d)), dtype=bool,
                            count=len(d))
        return table[self._t.columns[column]]


_DERIVED_LOCK = threading.Lock()


def _derived(t, name: str, make: Callable) -> np.ndarray:
    """What several queries derive from one host table, made once and kept
    on the table (statements run side by side, so under a lock)."""
    with _DERIVED_LOCK:
        kept = t._t.__dict__.setdefault("derived", {})
        if name not in kept:
            kept[name] = make()
        return kept[name]


def _cents(t, column: str) -> np.ndarray:
    """A DECIMAL column of a table as exact hundredths."""
    return _derived(t, column, lambda: _hundredths(t._t.columns[column]))


def _orow(T) -> np.ndarray:
    """Each lineitem's row of orders."""
    li, o = T["lineitem"], T["orders"]

    def find():
        if np.any(np.diff(o.o_orderkey) <= 0):
            raise ValueError("o_orderkey is not ascending")
        got = np.searchsorted(o.o_orderkey, li.l_orderkey)
        if not np.array_equal(o.o_orderkey[got], li.l_orderkey):
            raise ValueError("a lineitem names no order")
        return got

    return _derived(li, "orow", find)


def _revenue(li, m=None) -> np.ndarray:
    """l_extendedprice x (1 - l_discount) in exact ten-thousandths, of the
    rows m selects (all without m)."""
    ext, disc = _cents(li, "l_extendedprice"), _cents(li, "l_discount")
    if m is not None:
        ext, disc = ext[m], disc[m]
    return ext * (100 - disc)


def _by_key(values: np.ndarray) -> np.ndarray:
    """A column of a table keyed 1..n, indexable by the key itself."""
    return np.concatenate((values[:1], values))


def _nation_name(T, nationkey) -> str:
    n = T["nation"]
    return n.text("n_name", n.n_name[int(nationkey)])


def _region_nations(T, region: str) -> np.ndarray:
    """Per nation key: whether it lies in the region."""
    n, r = T["nation"], T["region"]
    rk = r.r_regionkey[r.is_("r_name", region)]
    return np.isin(n.n_regionkey, rk)


def _nation_key(T, name: str) -> int:
    n = T["nation"]
    return int(n.n_nationkey[n.is_("n_name", name)][0])


def q1(T):
    li = T["lineitem"]
    m = li.l_shipdate <= _day("1998-12-01") - 90
    nls = len(li.texts("l_linestatus"))
    g = (li.l_returnflag * nls + li.l_linestatus)[m]
    size = len(li.texts("l_returnflag")) * nls
    qty = _cents(li, "l_quantity")[m]
    ext = _cents(li, "l_extendedprice")[m]
    disc = _cents(li, "l_discount")[m]
    tax = _cents(li, "l_tax")[m]
    cnt = np.bincount(g, minlength=size)
    s_qty = _sums(g, qty, size)
    s_ext = _sums(g, ext, size)
    s_disc = _sums(g, ext * (100 - disc), size)
    s_charge = _sums(g, ext * (100 - disc) * (100 + tax), size)
    s_d = _sums(g, disc, size)
    out = []
    for k in np.nonzero(cnt)[0]:
        c = int(cnt[k])
        out.append((li.text("l_returnflag", k // nls),
                    li.text("l_linestatus", k % nls),
                    s_qty[k] / 100, s_ext[k] / 100, s_disc[k] / 10**4,
                    s_charge[k] / 10**6, s_qty[k] / 100 / c,
                    s_ext[k] / 100 / c, s_d[k] / 100 / c, c))
    return out


def q2(T):
    p, s, ps = T["part"], T["supplier"], T["partsupp"]
    europe = _region_nations(T, "EUROPE")[s.s_nationkey]   # per supplier
    e = europe[ps.ps_suppkey - 1]
    mins = np.full(p.n + 1, np.inf)
    np.minimum.at(mins, ps.ps_partkey[e], ps.ps_supplycost[e])
    part_ok = (p.p_size == 15) & p.like("p_type", "%BRASS")
    m = e & part_ok[ps.ps_partkey - 1] & (ps.ps_supplycost
                                          == mins[ps.ps_partkey])
    rows = []
    for pk, sk in zip(ps.ps_partkey[m], ps.ps_suppkey[m]):
        sr, pr = sk - 1, pk - 1
        rows.append((float(s.s_acctbal[sr]), s.text("s_name", s.s_name[sr]),
                     _nation_name(T, s.s_nationkey[sr]), int(pk),
                     p.text("p_mfgr", p.p_mfgr[pr]),
                     s.text("s_address", s.s_address[sr]),
                     s.text("s_phone", s.s_phone[sr]),
                     s.text("s_comment", s.s_comment[sr])))
    rows.sort(key=lambda r: (-r[0], r[2], r[1], r[3]))
    return rows[:100]


def q3(T):
    c, o, li = T["customer"], T["orders"], T["lineitem"]
    day = _day("1995-03-15")
    seg = c.is_("c_mktsegment", "BUILDING")
    o_ok = (o.o_orderdate < day) & seg[o.o_custkey - 1]
    orow = _orow(T)
    m = (li.l_shipdate > day) & o_ok[orow]
    idx = orow[m]
    rev = _sums(idx, _revenue(li, m), o.n)
    groups = np.nonzero(np.bincount(idx, minlength=o.n))[0]
    top = groups[np.lexsort((o.o_orderdate[groups], -rev[groups]))][:10]
    return [(int(o.o_orderkey[r]), rev[r] / 10**4, _date(o.o_orderdate[r]),
             int(o.o_shippriority[r])) for r in top]


def q4(T):
    o, li = T["orders"], T["lineitem"]
    late = np.zeros(o.n, dtype=bool)
    late[_orow(T)[li.l_commitdate < li.l_receiptdate]] = True
    m = (o.o_orderdate >= _day("1993-07-01")) \
        & (o.o_orderdate < _day("1993-10-01")) & late
    cnt = np.bincount(o.o_orderpriority[m],
                      minlength=len(o.texts("o_orderpriority")))
    return [(o.text("o_orderpriority", k), int(cnt[k]))
            for k in np.nonzero(cnt)[0]]


def q5(T):
    c, o, li, s = T["customer"], T["orders"], T["lineitem"], T["supplier"]
    orow = _orow(T)
    o_ok = (o.o_orderdate >= _day("1994-01-01")) \
        & (o.o_orderdate < _day("1995-01-01"))
    at = np.nonzero(o_ok[orow])[0]
    s_nat = _by_key(s.s_nationkey)[li.l_suppkey[at]]
    c_nat = _by_key(c.c_nationkey)[o.o_custkey[orow[at]]]
    keep = (c_nat == s_nat) & _region_nations(T, "ASIA")[s_nat]
    at, s_nat = at[keep], s_nat[keep]
    rev = _sums(s_nat, _revenue(li, at), 25)
    cnt = np.bincount(s_nat, minlength=25)
    rows = [(_nation_name(T, k), rev[k] / 10**4) for k in np.nonzero(cnt)[0]]
    rows.sort(key=lambda r: -r[1])
    return rows


def q6(T):
    li = T["lineitem"]
    disc = _cents(li, "l_discount")
    m = (li.l_shipdate >= _day("1994-01-01")) \
        & (li.l_shipdate < _day("1995-01-01")) \
        & (disc >= 5) & (disc <= 7) & (li.l_quantity < 24)
    if not m.any():
        return [(None,)]
    return [(_total(_cents(li, "l_extendedprice")[m] * disc[m]) / 10**4,)]


def q7(T):
    c, o, li, s = T["customer"], T["orders"], T["lineitem"], T["supplier"]
    fr, de = _nation_key(T, "FRANCE"), _nation_key(T, "GERMANY")
    at = np.nonzero((li.l_shipdate >= _day("1995-01-01"))
                    & (li.l_shipdate <= _day("1996-12-31")))[0]
    sn = _by_key(s.s_nationkey)[li.l_suppkey[at]]
    cn = _by_key(c.c_nationkey)[o.o_custkey[_orow(T)[at]]]
    keep = ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))
    at, sn, cn = at[keep], sn[keep], cn[keep]
    year = _years(li.l_shipdate[at])
    g = (sn * 25 + cn) * 2 + (year - 1995)
    size = 25 * 25 * 2
    rev = _sums(g, _revenue(li, at), size)
    cnt = np.bincount(g, minlength=size)
    rows = [(_nation_name(T, k // 50), _nation_name(T, k // 2 % 25),
             int(1995 + k % 2), rev[k] / 10**4) for k in np.nonzero(cnt)[0]]
    rows.sort(key=lambda r: r[:3])
    return rows


def q8(T):
    p, c, o, li, s = (T["part"], T["customer"], T["orders"], T["lineitem"],
                      T["supplier"])
    at = np.nonzero(_by_key(p.is_("p_type", "ECONOMY ANODIZED STEEL"))[
        li.l_partkey])[0]
    orow = _orow(T)[at]
    cn = _by_key(c.c_nationkey)[o.o_custkey[orow]]
    od = o.o_orderdate[orow]
    keep = _region_nations(T, "AMERICA")[cn] \
        & (od >= _day("1995-01-01")) & (od <= _day("1996-12-31"))
    at = at[keep]
    year = _years(od[keep]) - 1995
    vol = _revenue(li, at)
    brazil = _by_key(s.s_nationkey)[li.l_suppkey[at]] \
        == _nation_key(T, "BRAZIL")
    total = _sums(year, vol, 2)
    ours = _sums(year, np.where(brazil, vol, 0), 2)
    cnt = np.bincount(year, minlength=2)
    return [(int(1995 + k), float(ours[k]) / float(total[k]))
            for k in np.nonzero(cnt)[0]]


def _ps_rows(T, partkey, suppkey) -> np.ndarray:
    """The partsupp row of each (part, supplier) pair."""
    ps = T["partsupp"]
    width = T["supplier"].n + 1
    keys = ps.ps_partkey * width + ps.ps_suppkey
    order = np.argsort(keys, kind="stable")
    want = partkey * width + suppkey
    at = np.searchsorted(keys[order], want)
    rows = order[np.minimum(at, len(order) - 1)]
    if not np.array_equal(keys[rows], want):
        raise ValueError("a lineitem's (part, supplier) is not in partsupp")
    return rows


def q9(T):
    p, o, li, s, ps = (T["part"], T["orders"], T["lineitem"], T["supplier"],
                       T["partsupp"])
    m = np.nonzero(_by_key(p.like("p_name", "%green%"))[li.l_partkey])[0]
    pk, sk = li.l_partkey[m], li.l_suppkey[m]
    cost = _hundredths(ps.ps_supplycost)[_ps_rows(T, pk, sk)]
    amount = _revenue(li, m) - cost * _cents(li, "l_quantity")[m]
    nat = _by_key(s.s_nationkey)[sk]
    year = _years(o.o_orderdate[_orow(T)[m]])
    y0 = 1992
    g = nat * 8 + (year - y0)
    size = 25 * 8
    profit = _sums(g, amount, size)
    cnt = np.bincount(g, minlength=size)
    rows = [(_nation_name(T, k // 8), int(y0 + k % 8), profit[k] / 10**4)
            for k in np.nonzero(cnt)[0]]
    rows.sort(key=lambda r: (r[0], -r[1]))
    return rows


def q10(T):
    c, o, li = T["customer"], T["orders"], T["lineitem"]
    o_ok = (o.o_orderdate >= _day("1993-10-01")) \
        & (o.o_orderdate < _day("1994-01-01"))
    m = np.nonzero(li.is_("l_returnflag", "R"))[0]
    orow = _orow(T)[m]
    keep = o_ok[orow]
    m, orow = m[keep], orow[keep]
    crow = o.o_custkey[orow] - 1
    rev = _sums(crow, _revenue(li, m), c.n)
    groups = np.nonzero(np.bincount(crow, minlength=c.n))[0]
    top = groups[np.argsort(-rev[groups], kind="stable")][:20]
    return [(int(c.c_custkey[r]), c.text("c_name", c.c_name[r]),
             rev[r] / 10**4, float(c.c_acctbal[r]),
             _nation_name(T, c.c_nationkey[r]),
             c.text("c_address", c.c_address[r]),
             c.text("c_phone", c.c_phone[r]),
             c.text("c_comment", c.c_comment[r])) for r in top]


def q11(T):
    s, ps = T["supplier"], T["partsupp"]
    de = s.s_nationkey == _nation_key(T, "GERMANY")
    m = de[ps.ps_suppkey - 1]
    value = _hundredths(ps.ps_supplycost)[m] * ps.ps_availqty[m]   # cents
    pk = ps.ps_partkey[m]
    sums = _sums(pk, value, T["part"].n + 1)
    cnt = np.bincount(pk, minlength=T["part"].n + 1)
    threshold = (_total(value) / 100) * 0.00001
    keys = np.nonzero(cnt)[0]
    vals = sums[keys] / 100
    if len(keys):
        _log(f"Q11: nearest part value to the threshold {threshold!r}: "
             f"margin {np.abs(vals - threshold).min() / threshold:.3e} of it")
    keep = vals > threshold
    rows = [(int(k), float(v)) for k, v in zip(keys[keep], vals[keep])]
    rows.sort(key=lambda r: -r[1])
    return rows


def q12(T):
    o, li = T["orders"], T["lineitem"]
    orow = _orow(T)
    mode = li.l_shipmode
    m = ((mode == li.code("l_shipmode", "MAIL"))
         | (mode == li.code("l_shipmode", "SHIP"))) \
        & (li.l_commitdate < li.l_receiptdate) \
        & (li.l_shipdate < li.l_commitdate) \
        & (li.l_receiptdate >= _day("1994-01-01")) \
        & (li.l_receiptdate < _day("1995-01-01"))
    prio = o.o_orderpriority[orow[m]]
    high = (prio == o.code("o_orderpriority", "1-URGENT")) \
        | (prio == o.code("o_orderpriority", "2-HIGH"))
    size = len(li.texts("l_shipmode"))
    n_high = np.bincount(mode[m][high], minlength=size)
    n_all = np.bincount(mode[m], minlength=size)
    return [(li.text("l_shipmode", k), int(n_high[k]),
             int(n_all[k] - n_high[k])) for k in np.nonzero(n_all)[0]]


def q13(T):
    c, o = T["customer"], T["orders"]
    keep = ~o.like("o_comment", "%special%requests%")
    per = np.bincount(o.o_custkey[keep] - 1, minlength=c.n)
    dist = np.bincount(per)
    rows = [(int(k), int(dist[k])) for k in np.nonzero(dist)[0]]
    rows.sort(key=lambda r: (-r[1], -r[0]))
    return rows


def q14(T):
    p, li = T["part"], T["lineitem"]
    m = (li.l_shipdate >= _day("1995-09-01")) \
        & (li.l_shipdate < _day("1995-10-01"))
    if not m.any():
        return [(None,)]
    rev = _revenue(li, m)
    promo = p.like("p_type", "PROMO%")[li.l_partkey[m] - 1]
    return [(100.00 * (_total(rev[promo]) / 10**4)
             / (_total(rev) / 10**4),)]


def q15(T):
    s, li = T["supplier"], T["lineitem"]
    m = (li.l_shipdate >= _day("1996-01-01")) \
        & (li.l_shipdate < _day("1996-04-01"))
    sk = li.l_suppkey[m] - 1
    rev = _sums(sk, _revenue(li, m), s.n)
    cnt = np.bincount(sk, minlength=s.n)
    if not cnt.any():
        return []
    best = rev[cnt > 0].max()
    return [(int(s.s_suppkey[r]), s.text("s_name", s.s_name[r]),
             s.text("s_address", s.s_address[r]),
             s.text("s_phone", s.s_phone[r]), rev[r] / 10**4)
            for r in np.nonzero((rev == best) & (cnt > 0))[0]]


def q16(T):
    p, s, ps = T["part"], T["supplier"], T["partsupp"]
    sizes = np.zeros(51, dtype=bool)
    sizes[[49, 14, 23, 45, 19, 3, 36, 9]] = True
    part_ok = (p.p_brand != p.code("p_brand", "Brand#45")) \
        & ~p.like("p_type", "MEDIUM POLISHED%") & sizes[p.p_size]
    complains = s.like("s_comment", "%Customer%Complaints%")
    m = part_ok[ps.ps_partkey - 1] & ~complains[ps.ps_suppkey - 1]
    pr = ps.ps_partkey[m] - 1
    n_types = len(p.texts("p_type"))
    g = (p.p_brand[pr].astype(np.int64) * n_types + p.p_type[pr]) * 51 \
        + p.p_size[pr]
    pairs = np.unique(g * (s.n + 1) + ps.ps_suppkey[m])
    groups, counts = np.unique(pairs // (s.n + 1), return_counts=True)
    rows = [(p.text("p_brand", k // 51 // n_types),
             p.text("p_type", k // 51 % n_types), int(k % 51), int(n))
            for k, n in zip(groups, counts)]
    rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
    return rows


def q17(T):
    p, li = T["part"], T["lineitem"]
    part_ok = p.is_("p_brand", "Brand#23") & p.is_("p_container", "MED BOX")
    m = np.nonzero(_by_key(part_ok)[li.l_partkey])[0]
    pr = li.l_partkey[m] - 1
    qty = li.l_quantity[m]
    avg = np.bincount(pr, weights=qty, minlength=p.n) / np.maximum(
        np.bincount(pr, minlength=p.n), 1)
    small = qty < 0.2 * avg[pr]
    if not small.any():
        return [(None,)]
    return [((_total(_cents(li, "l_extendedprice")[m][small]) / 100)
             / 7.0,)]


def q18(T):
    c, o, li = T["customer"], T["orders"], T["lineitem"]
    orow = _orow(T)
    qty = _sums(orow, _cents(li, "l_quantity"), o.n)
    big = np.nonzero(qty > 300 * 100)[0]
    rows = []
    for r in big:
        cr = o.o_custkey[r] - 1
        rows.append((c.text("c_name", c.c_name[cr]), int(c.c_custkey[cr]),
                     int(o.o_orderkey[r]), _date(o.o_orderdate[r]),
                     float(o.o_totalprice[r]), qty[r] / 100))
    rows.sort(key=lambda r: (-r[4], r[3]))
    return rows[:100]


def q19(T):
    p, li = T["part"], T["lineitem"]
    mode = li.l_shipmode
    air = (mode == li.code("l_shipmode", "AIR")) \
        | (mode == li.code("l_shipmode", "AIR REG"))
    m = air & li.is_("l_shipinstruct", "DELIVER IN PERSON")
    pr = li.l_partkey[m] - 1
    qty = li.l_quantity[m]
    any_ = np.zeros(int(m.sum()), dtype=bool)
    for brand, box, lo, size in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10,
             10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20,
             15)):
        ok = p.is_("p_brand", brand) & np.isin(
            p.p_container, [p.code("p_container", b) for b in box]) \
            & (p.p_size >= 1) & (p.p_size <= size)
        any_ |= ok[pr] & (qty >= lo) & (qty <= lo + 10)
    if not any_.any():
        return [(None,)]
    return [(_total(_revenue(li, m)[any_]) / 10**4,)]


def q20(T):
    p, s, ps, li = T["part"], T["supplier"], T["partsupp"], T["lineitem"]
    forest = p.like("p_name", "forest%")
    width = s.n + 1
    m = _by_key(forest)[li.l_partkey] \
        & (li.l_shipdate >= _day("1994-01-01")) \
        & (li.l_shipdate < _day("1995-01-01"))
    pairs, inv = np.unique(li.l_partkey[m] * width + li.l_suppkey[m],
                           return_inverse=True)
    qsum = np.bincount(inv, weights=li.l_quantity[m], minlength=len(pairs))
    rows = np.nonzero(forest[ps.ps_partkey - 1])[0]
    want = ps.ps_partkey[rows] * width + ps.ps_suppkey[rows]
    at = np.minimum(np.searchsorted(pairs, want), max(len(pairs) - 1, 0))
    found = (pairs[at] == want) if len(pairs) else np.zeros(len(rows), bool)
    ok = found & (ps.ps_availqty[rows] > 0.5 * np.where(found, qsum[at], 0))
    supp = np.zeros(s.n, dtype=bool)
    supp[ps.ps_suppkey[rows[ok]] - 1] = True
    sel = supp & (s.s_nationkey == _nation_key(T, "CANADA"))
    rows = [(s.text("s_name", s.s_name[r]),
             s.text("s_address", s.s_address[r])) for r in np.nonzero(sel)[0]]
    rows.sort()
    return rows


def q21(T):
    s, o, li = T["supplier"], T["orders"], T["lineitem"]
    # the lines of orders with status F
    at = np.nonzero(o.is_("o_orderstatus", "F")[_orow(T)])[0]
    orow = _orow(T)[at]
    supp = li.l_suppkey[at]
    late = li.l_receiptdate[at] > li.l_commitdate[at]

    def one_supplier(mask):
        """Per order: whether the lines the mask selects (at least one)
        share one supplier, i.e. n * sum(k^2) == sum(k)^2, exact in
        float64 at these sizes."""
        k = supp[mask].astype(np.float64)
        n = np.bincount(orow[mask], minlength=o.n)
        s1 = np.bincount(orow[mask], weights=k, minlength=o.n)
        s2 = np.bincount(orow[mask], weights=k * k, minlength=o.n)
        return n * s2 == s1 * s1

    sa = _by_key(s.s_nationkey == _nation_key(T, "SAUDI ARABIA"))
    # l1 is late, so "no other supplier's late line" is one late supplier,
    # and "another supplier's line" is more than one supplier
    m = late & sa[supp] & ~one_supplier(slice(None))[orow] \
        & one_supplier(late)[orow]
    cnt = np.bincount(supp[m] - 1, minlength=s.n)
    rows = [(s.text("s_name", s.s_name[r]), int(cnt[r]))
            for r in np.nonzero(cnt)[0]]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows[:100]


def q22(T):
    c, o = T["customer"], T["orders"]
    codes = ("13", "31", "23", "29", "30", "18", "17")
    prefix = np.asarray([v[:2] for v in c.texts("c_phone")], dtype=object)
    in_list = np.isin(prefix, codes)[c.c_phone]
    pos = in_list & (c.c_acctbal > 0.00)
    cents = _hundredths(c.c_acctbal)
    avg = (_total(cents[pos]) / 100) / int(pos.sum())
    _log(f"Q22: nearest balance to the average {avg!r}: margin "
         f"{np.abs(c.c_acctbal[in_list] - avg).min() / avg:.3e} of it")
    ordered = np.zeros(c.n, dtype=bool)
    ordered[o.o_custkey - 1] = True
    m = in_list & (c.c_acctbal > avg) & ~ordered
    cc = np.asarray([int(v) for v in prefix[c.c_phone[m]]]) if m.any() \
        else np.zeros(0, dtype=np.int64)
    num = np.bincount(cc, minlength=100)
    tot = _sums(cc, cents[m], 100)
    return [(f"{k:02d}", int(num[k]), tot[k] / 100)
            for k in np.nonzero(num)[0]]


ORACLES: Dict[str, Callable] = {f"Q{i}": f for i, f in enumerate(
    (q1, q2, q3, q4, q5, q6, q7, q8, q9, q10, q11, q12, q13, q14, q15, q16,
     q17, q18, q19, q20, q21, q22), start=1)}

ORDER: Dict[str, tuple] = {
    "Q1": (0, 1), "Q2": (0, 2, 1, 3), "Q3": (1, 2), "Q4": (0,), "Q5": (1,),
    "Q6": (), "Q7": (0, 1, 2), "Q8": (0,), "Q9": (0, 1), "Q10": (2,),
    "Q11": (1,), "Q12": (0,), "Q13": (1, 0), "Q14": (), "Q15": (0,),
    "Q16": (3, 0, 1, 2), "Q17": (), "Q18": (4, 3), "Q19": (), "Q20": (0,),
    "Q21": (1, 0), "Q22": (0,),
}

# the DECIMAL columns: the control computes them in float32, and rounds
# the float values it returns to float32
MEASURES = {
    "lineitem": ("l_quantity", "l_extendedprice", "l_discount", "l_tax"),
    "orders": ("o_totalprice",), "part": ("p_retailprice",),
    "partsupp": ("ps_supplycost",), "supplier": ("s_acctbal",),
    "customer": ("c_acctbal",),
}
ROUND32 = (float,)


def run(query: str, tables: Dict[str, HostTable]) -> list:
    """The reference's rows of one query; its seconds go to standard
    error."""
    t0 = time.perf_counter()
    rows = ORACLES[query]({k: _T(v) for k, v in tables.items()})
    _log(f"{query}: {time.perf_counter() - t0:.3f} s")
    return rows
