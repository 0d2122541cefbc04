"""The plain reference of the SSB cells: a numpy function a query.

Each function computes a query's rows straight from the host tables of
`data/ssb.py`: a dimension key k sits at row k - 1, so a join is a
fancy-index lookup (a date key through a table over the yyyymmdd range), a
string predicate is a compare with the value's code
in the column's sorted dictionary, and a GROUP BY is a `bincount` over a
dense group code. Every value is an integer: the sums are taken in float64,
exact while they stay below 2^53 (checked), and returned as int.

`run(name, tables)` gives a query's rows; `ORDER` names the result columns
each query orders by; `MEASURES` names the columns the control computes in
float32.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from port_bench.tables import HostTable

EXACT = float(2 ** 53)


class _T:
    """Attribute access to one host table's columns; strings as codes."""

    def __init__(self, t: HostTable):
        self._t = t
        self.n = t.num_rows

    def __getattr__(self, name):
        return self._t.columns[name]

    def code(self, column: str, value: str) -> int:
        return self._t.code(column, value)

    def size(self, column: str) -> int:
        return len(self._t.dicts[column])

    def text(self, column: str, code) -> str:
        return str(self._t.dicts[column][int(code)])


class _Facts:
    """The lineorder rows with each dimension's row beside them (a cell
    that registers only lineorder and date has no other dimension)."""

    def __init__(self, T):
        self.lo, self.d = T["lineorder"], T["date"]
        self.c, self.s, self.p = (T.get("customer"), T.get("supplier"),
                                  T.get("part"))
        keys = self.d.d_datekey
        lut = np.full(int(keys.max() - keys.min()) + 1, -1, dtype=np.int64)
        lut[keys - keys.min()] = np.arange(len(keys))
        self.drow = lut[self.lo.lo_orderdate - keys.min()]
        if (self.drow < 0).any():
            raise ValueError("lo_orderdate outside the date table")
        self.crow = self.lo.lo_custkey - 1
        self.srow = self.lo.lo_suppkey - 1
        self.prow = self.lo.lo_partkey - 1

    def year(self):
        return self.d.d_year[self.drow]


def _isum(values) -> int:
    total = float(np.sum(values, dtype=np.float64))
    if abs(total) >= EXACT:
        raise OverflowError("a sum passes 2^53")
    return total


def _grouped(codes, values, size):
    sums = np.bincount(codes, weights=values.astype(np.float64),
                       minlength=size)
    if len(sums) and np.abs(sums).max() >= EXACT:
        raise OverflowError("a sum passes 2^53")
    return sums, np.bincount(codes, minlength=size)


def _number(x) -> int:
    return int(round(float(x)))


def _flight1(F, m):
    lo = F.lo
    if not m.any():
        return [(None,)]
    return [(_number(_isum(lo.lo_extendedprice[m] * lo.lo_discount[m])),)]


def q1_1(T):
    F = _Facts(T)
    lo = F.lo
    m = (F.year() == 1993) & (lo.lo_discount >= 1) & (lo.lo_discount <= 3) \
        & (lo.lo_quantity < 25)
    return _flight1(F, m)


def q1_2(T):
    F = _Facts(T)
    lo = F.lo
    m = (F.d.d_yearmonthnum[F.drow] == 199401) & (lo.lo_discount >= 4) \
        & (lo.lo_discount <= 6) & (lo.lo_quantity >= 26) \
        & (lo.lo_quantity <= 35)
    return _flight1(F, m)


def q1_3(T):
    F = _Facts(T)
    lo = F.lo
    m = (F.d.d_weeknuminyear[F.drow] == 6) & (F.year() == 1994) \
        & (lo.lo_discount >= 5) & (lo.lo_discount <= 7) \
        & (lo.lo_quantity >= 26) & (lo.lo_quantity <= 35)
    return _flight1(F, m)


def _flight2(T, part_ok, region):
    F = _Facts(T)
    p, s = F.p, F.s
    m = part_ok[F.prow] & (s.s_region[F.srow] == s.code("s_region", region))
    year = F.year()[m] - 1992
    nb = p.size("p_brand1")
    code = year * nb + p.p_brand1[F.prow[m]]
    sums, cnt = _grouped(code, F.lo.lo_revenue[m], 16 * nb)
    return [(_number(sums[g]), int(g // nb + 1992), p.text("p_brand1", g % nb))
            for g in np.nonzero(cnt)[0]]


def q2_1(T):
    p = T["part"]
    return _flight2(T, p.p_category == p.code("p_category", "MFGR#12"),
                    "AMERICA")


def q2_2(T):
    p = T["part"]
    d = p._t.dicts["p_brand1"]
    ok = np.asarray([("MFGR#2221" <= v <= "MFGR#2228") for v in d])
    return _flight2(T, ok[p.p_brand1], "ASIA")


def q2_3(T):
    p = T["part"]
    return _flight2(T, p.p_brand1 == p.code("p_brand1", "MFGR#2239"),
                    "EUROPE")


def _flight3(F, m, c_col, s_col):
    """GROUP BY (c_col, s_col, d_year) ORDER BY d_year, revenue DESC."""
    c, s = F.c, F.s
    nc, ns = c.size(c_col), s.size(s_col)
    year = F.year()[m] - 1992
    code = (c._t.columns[c_col][F.crow[m]].astype(np.int64) * ns
            + s._t.columns[s_col][F.srow[m]]) * 16 + year
    sums, cnt = _grouped(code, F.lo.lo_revenue[m], nc * ns * 16)
    groups = np.nonzero(cnt)[0]
    order = groups[np.lexsort((-sums[groups], groups % 16))]
    return [(c.text(c_col, g // 16 // ns), s.text(s_col, g // 16 % ns),
             int(g % 16 + 1992), _number(sums[g])) for g in order]


def _in(t: _T, column: str, values) -> np.ndarray:
    col = t._t.columns[column]
    m = np.zeros(len(col), dtype=bool)
    for v in values:
        m |= col == t.code(column, v)
    return m


def q3_1(T):
    F = _Facts(T)
    c, s = F.c, F.s
    y = F.year()
    m = (c.c_region[F.crow] == c.code("c_region", "ASIA")) \
        & (s.s_region[F.srow] == s.code("s_region", "ASIA")) \
        & (y >= 1992) & (y <= 1997)
    return _flight3(F, m, "c_nation", "s_nation")


def q3_2(T):
    F = _Facts(T)
    c, s = F.c, F.s
    y = F.year()
    m = (c.c_nation[F.crow] == c.code("c_nation", "UNITED STATES")) \
        & (s.s_nation[F.srow] == s.code("s_nation", "UNITED STATES")) \
        & (y >= 1992) & (y <= 1997)
    return _flight3(F, m, "c_city", "s_city")


_KI = ("UNITED KI1", "UNITED KI5")


def q3_3(T):
    F = _Facts(T)
    y = F.year()
    m = _in(F.c, "c_city", _KI)[F.crow] & _in(F.s, "s_city", _KI)[F.srow] \
        & (y >= 1992) & (y <= 1997)
    return _flight3(F, m, "c_city", "s_city")


def q3_4(T):
    F = _Facts(T)
    d = F.d
    m = _in(F.c, "c_city", _KI)[F.crow] & _in(F.s, "s_city", _KI)[F.srow] \
        & (d.d_yearmonth[F.drow] == d.code("d_yearmonth", "Dec1997"))
    return _flight3(F, m, "c_city", "s_city")


def _flight4(F, m, keys):
    """GROUP BY (d_year, *keys) ORDER BY the same, of revenue - supplycost;
    keys are (table, row, column) of dimension string columns."""
    code = F.year()[m].astype(np.int64) - 1992
    size = 16
    for t, row, col in keys:
        n = t.size(col)
        code = code * n + t._t.columns[col][row[m]]
        size *= n
    lo = F.lo
    sums, cnt = _grouped(code, lo.lo_revenue[m] - lo.lo_supplycost[m], size)
    rows = []
    for g in np.nonzero(cnt)[0]:
        parts, rest = [], int(g)
        for t, _, col in reversed(keys):
            n = t.size(col)
            parts.append(t.text(col, rest % n))
            rest //= n
        rows.append((rest + 1992, *reversed(parts), _number(sums[g])))
    return rows


def _mfgr12(p):
    return _in(p, "p_mfgr", ("MFGR#1", "MFGR#2"))


def q4_1(T):
    F = _Facts(T)
    c, s = F.c, F.s
    m = (c.c_region[F.crow] == c.code("c_region", "AMERICA")) \
        & (s.s_region[F.srow] == s.code("s_region", "AMERICA")) \
        & _mfgr12(F.p)[F.prow]
    return _flight4(F, m, [(c, F.crow, "c_nation")])


def q4_2(T):
    F = _Facts(T)
    c, s, p = F.c, F.s, F.p
    y = F.year()
    m = (c.c_region[F.crow] == c.code("c_region", "AMERICA")) \
        & (s.s_region[F.srow] == s.code("s_region", "AMERICA")) \
        & ((y == 1997) | (y == 1998)) & _mfgr12(p)[F.prow]
    return _flight4(F, m, [(s, F.srow, "s_nation"),
                           (p, F.prow, "p_category")])


def q4_3(T):
    F = _Facts(T)
    c, s, p = F.c, F.s, F.p
    y = F.year()
    m = (c.c_region[F.crow] == c.code("c_region", "AMERICA")) \
        & (s.s_nation[F.srow] == s.code("s_nation", "UNITED STATES")) \
        & ((y == 1997) | (y == 1998)) \
        & (p.p_category[F.prow] == p.code("p_category", "MFGR#14"))
    return _flight4(F, m, [(s, F.srow, "s_city"), (p, F.prow, "p_brand1")])


ORACLES: Dict[str, Callable] = {
    "Q1.1": q1_1, "Q1.2": q1_2, "Q1.3": q1_3, "Q2.1": q2_1, "Q2.2": q2_2,
    "Q2.3": q2_3, "Q3.1": q3_1, "Q3.2": q3_2, "Q3.3": q3_3, "Q3.4": q3_4,
    "Q4.1": q4_1, "Q4.2": q4_2, "Q4.3": q4_3,
}

ORDER: Dict[str, tuple] = {
    "Q1.1": (), "Q1.2": (), "Q1.3": (), "Q2.1": (1, 2), "Q2.2": (1, 2),
    "Q2.3": (1, 2), "Q3.1": (2, 3), "Q3.2": (2, 3), "Q3.3": (2, 3),
    "Q3.4": (2, 3), "Q4.1": (0, 1), "Q4.2": (0, 1, 2), "Q4.3": (0, 1, 2),
}

# the columns summed: the control computes them in float32, and rounds
# the integer sums it returns to float32
MEASURES = {"lineorder": ("lo_extendedprice", "lo_discount", "lo_revenue",
                          "lo_supplycost")}
ROUND32 = (int,)


def run(query: str, tables: Dict[str, HostTable]) -> list:
    """The reference's rows of one query."""
    return ORACLES[query]({k: _T(v) for k, v in tables.items()})
