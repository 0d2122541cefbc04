"""Statistics, GROUPING(), scalar functions, regexes and INTERVAL arithmetic
over the TPC-H tables of `data.generate`, each with a numpy oracle.

  F1  STDDEV_SAMP, VAR_POP, CORR, REGR_SLOPE and REGR_INTERCEPT per
      (l_returnflag, l_linestatus), under TPC-H Q1's date bound written as
      TPC-H writes it, DATE '1998-12-01' - INTERVAL '90 days';
  F2  DATE_TRUNC('quarter'), ROUND(AVG, 2), MAX(ABS(x - c)) and
      SUM(k % 7) over orders;
  F3  a CUBE over two string keys with GROUPING();
  F4  UPPER(SPLIT_PART()), LENGTH() and a `~` filter over part;
  F5  %, NULLIF, GREATEST, LEAST, COALESCE, SQRT, ABS, CEIL and POWER
      over customer;
  F6  TPC-H Q1 (`queries.QUERIES["Q1"]`) with its date bound as in F1;
      its rows are `oracle.q1`'s.

Each oracle computes its rows from the host tables with numpy alone, in the
form `ColumnBatch.to_pylist()` gives them. The statistics are two-pass, per
group (`np.var`, `np.std`, `np.cov`, `np.corrcoef` over the group's rows),
not the engine's one-pass formula over SUM(x), SUM(x*x) and COUNT; dates
are truncated through numpy's datetime64; strings are mapped once per
dictionary value. `compare` holds an engine's rows against them:
integers, strings and dates exactly, floats at rtol 1e-9.

`cancellation(tables)` gives F1's cancellation factors: for each group and
statistic, the raw second moment the engine sums over the centred one it
keeps (sum(x^2) / m2, sum(x*y) / c2). The card sums each moment in fixed
point (`ops/group_agg.py`); the formula's subtraction multiplies the sum's
relative error by this factor.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from query_engine_tpu_torch.tpch.data import HostTable, days
from query_engine_tpu_torch.tpch.oracle import RTOL, _T, _date, q1
from query_engine_tpu_torch.tpch.oracle import compare as _compare
from query_engine_tpu_torch.tpch.queries import QUERIES as TPCH

Q1_BOUND = "l_shipdate <= DATE '1998-12-01' - INTERVAL '90 days'"

QUERIES = {
    "F1": (
        "SELECT l_returnflag, l_linestatus, COUNT(*) AS n, "
        "STDDEV_SAMP(l_extendedprice) AS sd, VAR_POP(l_quantity) AS vq, "
        "CORR(l_quantity, l_extendedprice) AS r, "
        "REGR_SLOPE(l_extendedprice, l_quantity) AS b, "
        "REGR_INTERCEPT(l_extendedprice, l_quantity) AS a "
        f"FROM lineitem WHERE {Q1_BOUND} "
        "GROUP BY l_returnflag, l_linestatus "
        "ORDER BY l_returnflag, l_linestatus"
    ),
    "F2": (
        "SELECT DATE_TRUNC('quarter', o_orderdate) AS q, COUNT(*) AS c, "
        "ROUND(AVG(o_totalprice), 2) AS a, "
        "MAX(ABS(o_totalprice - 150000.0)) AS dev, "
        "SUM(o_orderkey % 7) AS r "
        "FROM orders GROUP BY DATE_TRUNC('quarter', o_orderdate) "
        "ORDER BY q"
    ),
    "F3": (
        "SELECT l_returnflag, l_shipmode, "
        "GROUPING(l_returnflag, l_shipmode) AS g, "
        "COUNT(*) AS c, SUM(l_quantity) AS s "
        "FROM lineitem GROUP BY CUBE (l_returnflag, l_shipmode) "
        "ORDER BY g, l_returnflag, l_shipmode"
    ),
    "F4": (
        "SELECT UPPER(SPLIT_PART(p_type, ' ', 1)) AS t, "
        "LENGTH(p_container) AS n, COUNT(*) AS c, AVG(p_size) AS a "
        "FROM part WHERE p_name ~ '^(green|blue)' "
        "GROUP BY UPPER(SPLIT_PART(p_type, ' ', 1)), LENGTH(p_container) "
        "ORDER BY t, n"
    ),
    "F5": (
        "SELECT c_nationkey % 5 AS b, COUNT(NULLIF(c_nationkey % 5, 0)) AS nz, "
        "SUM(GREATEST(c_acctbal, 0.0)) AS pos, "
        "SUM(LEAST(c_acctbal, 0.0)) AS neg, "
        "SUM(COALESCE(NULLIF(c_acctbal, 0.0), -1.0)) AS co, "
        "AVG(SQRT(ABS(c_acctbal))) AS rt, MIN(CEIL(c_acctbal)) AS lo, "
        "MAX(POWER(c_acctbal / 1000.0, 2)) AS p "
        "FROM customer GROUP BY c_nationkey % 5 ORDER BY b"
    ),
    "F6": TPCH["Q1"].replace("l_shipdate <= '1998-09-02'", Q1_BOUND),
}
assert Q1_BOUND in QUERIES["F6"]

# the queries whose COUNT, SUM or AVG runs the group_agg kernel on the card
GROUP_AGG = ("F1", "F2", "F3", "F5", "F6")
# the query whose filter and GROUP BY build host tables (a regex match
# table, per-value UPPER(SPLIT_PART()) and LENGTH): on the card they run as
# eager leaves by design
STRING_FN_QUERIES = ("F4",)


def _groups(*codes_and_sizes):
    """(dense group code per row, number of codes) of non-negative keys."""
    code = np.zeros(len(codes_and_sizes[0][0]), dtype=np.int64)
    n = 1
    for c, size in codes_and_sizes:
        code = code * size + c.astype(np.int64)
        n *= size
    return code, n


def _f1_groups(T):
    li = T["lineitem"]
    m = li.l_shipdate <= days(1998, 9, 2)
    nls = len(li._t.dicts["l_linestatus"])
    code, n = _groups((li.l_returnflag[m], len(li._t.dicts["l_returnflag"])),
                      (li.l_linestatus[m], nls))
    price = li.l_extendedprice[m]
    qty = li.l_quantity[m].astype(np.float64)
    for g in range(n):
        sel = code == g
        if sel.any():
            yield (li.text("l_returnflag", [g // nls])[0],
                   li.text("l_linestatus", [g % nls])[0], price[sel],
                   qty[sel])


def f1(T):
    rows = []
    for rf, ls, y, x in _f1_groups(T):
        cov = np.cov(x, y, ddof=0)[0, 1]
        slope = cov / np.var(x)
        rows.append((rf, ls, int(len(y)), float(np.std(y, ddof=1)),
                     float(np.var(x)), float(np.corrcoef(x, y)[0, 1]),
                     float(slope), float(np.mean(y) - slope * np.mean(x))))
    return rows


def _quarter_start(d: np.ndarray) -> np.ndarray:
    """Days of the first day of each date's quarter, via datetime64."""
    month = d.astype("datetime64[D]").astype("datetime64[M]").astype(np.int64)
    start = (month - month % 3).astype("datetime64[M]")
    return start.astype("datetime64[D]").astype(np.int64)


def _round2(x: float) -> float:
    """ROUND(x, 2): half away from zero."""
    return math.copysign(math.floor(abs(x) * 100.0 + 0.5) / 100.0, x)


def _f2_avgs(T, exact_sums=False):
    o = T["orders"]
    q, code = np.unique(_quarter_start(o.o_orderdate), return_inverse=True)
    cnt = np.bincount(code)
    if exact_sums:  # each group's sum correctly rounded
        order = np.argsort(code, kind="stable")
        parts = np.split(o.o_totalprice[order], np.cumsum(cnt)[:-1])
        avg = np.array([math.fsum(p) for p in parts]) / cnt
    else:
        avg = np.bincount(code, weights=o.o_totalprice) / cnt
    return o, q, code, cnt, avg


def f2(T, exact_sums=False):
    o, q, code, cnt, avg = _f2_avgs(T, exact_sums)
    dev = np.zeros(len(q))
    np.maximum.at(dev, code, np.abs(o.o_totalprice - 150000.0))
    r = np.bincount(code, weights=o.o_orderkey % 7).astype(np.int64)
    return [(_date(q[g]), int(cnt[g]), _round2(float(avg[g])),
             float(dev[g]), int(r[g])) for g in range(len(q))]


def f3(T):
    li = T["lineitem"]
    flags = li._t.dicts["l_returnflag"]
    modes = li._t.dicts["l_shipmode"]
    qty = li.l_quantity
    rows = []
    for g, keys in ((0, ("f", "m")), (1, ("f",)), (2, ("m",)), (3, ())):
        fs = range(len(flags)) if "f" in keys else [None]
        ms = range(len(modes)) if "m" in keys else [None]
        for f in fs:
            for m in ms:
                sel = np.ones(li.n, dtype=bool)
                if f is not None:
                    sel &= li.l_returnflag == f
                if m is not None:
                    sel &= li.l_shipmode == m
                if sel.any():
                    rows.append((None if f is None else str(flags[f]),
                                 None if m is None else str(modes[m]), g,
                                 int(sel.sum()), int(qty[sel].sum())))
    return rows


def f4(T):
    p = T["part"]
    keep = p.where("p_name", lambda v: v.startswith(("green", "blue")))
    kind = np.asarray([v.split(" ")[0].upper() for v in p._t.dicts["p_type"]],
                      dtype=object)[p.p_type[keep]]
    size = np.asarray([len(v.encode("utf-8"))
                       for v in p._t.dicts["p_container"]])[p.p_container[keep]]
    rows = []
    for t in sorted(set(kind)):
        for n in sorted(set(size[kind == t].tolist())):
            sel = (kind == t) & (size == n)
            rows.append((str(t), int(n), int(sel.sum()),
                         float(p.p_size[keep][sel].mean())))
    return rows


def f5(T):
    c = T["customer"]
    b = c.c_nationkey % 5
    x = c.c_acctbal
    rows = []
    for g in np.unique(b):
        v = x[b == g]
        rows.append((int(g), int(len(v)) if g != 0 else 0,
                     float(np.maximum(v, 0.0).sum()),
                     float(np.minimum(v, 0.0).sum()),
                     float(np.where(v == 0.0, -1.0, v).sum()),
                     float(np.sqrt(np.abs(v)).mean()),
                     float(np.ceil(v).min()),
                     float(((v / 1000.0) ** 2).max())))
    return rows


ORACLES = {"F1": f1, "F2": f2, "F3": f3, "F4": f4, "F5": f5, "F6": q1}


def run(query: str, tables: Dict[str, HostTable],
        exact_sums: bool = False) -> list:
    """The oracle's rows of one query over the tables of data.generate.
    With `exact_sums`, F2's averages divide each group's correctly rounded
    sum (math.fsum), as the card's exact fixed-point sums give it, in place
    of numpy's float64 summation (the JAX package's CPU path sums the same
    way): where a group's mean lies on a tie of ROUND(., 2), only the
    exact sum decides it the way exact arithmetic does."""
    T = {k: _T(v) for k, v in tables.items()}
    if query == "F2":
        return f2(T, exact_sums)
    return ORACLES[query](T)


def compare(query: str, got: list, want: list, rtol: float = RTOL) -> float:
    """Raises AssertionError unless `got` equals `want` row for row
    (`oracle.compare`); returns the largest relative error of a float
    cell."""
    try:
        return _compare(got, want, rtol=rtol)
    except AssertionError as e:
        raise AssertionError(f"{query}: {e}") from None


def float_errors(got: list, want: list) -> Dict[int, float]:
    """The largest relative error of each float column (by position)."""
    out: Dict[int, float] = {}
    for g, w in zip(got, want):
        for c, (a, b) in enumerate(zip(g, w)):
            if isinstance(a, float) and isinstance(b, float) \
                    and math.isfinite(a) and math.isfinite(b):
                err = abs(a - b) / abs(b) if b else abs(a - b)
                out[c] = max(out.get(c, 0.0), err)
    return out


def cancellation(tables: Dict[str, HostTable]) -> Dict[str, Dict[str, float]]:
    """F1 per group: sum(y^2) / m2(y) for sd, sum(x^2) / m2(x) for vq, and
    |sum(x*y)| / |c2(x, y)| for r, b and a (y l_extendedprice, x
    l_quantity)."""
    out = {}
    for rf, ls, y, x in _f1_groups({k: _T(v) for k, v in tables.items()}):
        c2 = float(((x - x.mean()) * (y - y.mean())).sum())
        out[rf + ls] = {
            "sd": float((y * y).sum() / ((y - y.mean()) ** 2).sum()),
            "vq": float((x * x).sum() / ((x - x.mean()) ** 2).sum()),
            "r,b,a": abs(float((x * y).sum()) / c2) if c2 else math.inf,
        }
    return out


def f2_round_margin(tables: Dict[str, HostTable]) -> float:
    """How close F2's AVG(o_totalprice) came to a tie of ROUND(., 2), as a
    share of the rounding step: a group closer than the sum's error could
    round the other way on the card."""
    *_, avg = _f2_avgs({k: _T(v) for k, v in tables.items()})
    frac = np.abs(avg) * 100.0 - np.floor(np.abs(avg) * 100.0)
    return float(np.min(np.abs(frac - 0.5)))
