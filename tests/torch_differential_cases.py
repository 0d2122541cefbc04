"""The cases of tests/test_differential.py for the port, with no pandas and
no JAX, so the card's variant runs where neither is installed.

`make_table_dicts` draws the same tables as `test_differential.make_tables`
(the same seeded generator calls in the same order): 500 rows of `t` with
NULLs in k and v, NULL and duplicate strings in s, and 60 rows of `d` with
duplicate keys. `CASES` holds each case's SQL and whether its rows come in
ORDER BY order; `same` holds two row lists equal, integers and strings
exactly and floats to rtol 1e-9.
"""

import math

import numpy as np

RTOL = 1e-9

CASES = {
    "filter": ("SELECT id FROM t WHERE v > 250 AND k < 10", False),
    "groupby": ("SELECT k, COUNT(*), COUNT(v), SUM(v), MIN(v), MAX(v) "
                "FROM t GROUP BY k", False),
    "avg_float": ("SELECT AVG(f) FROM t WHERE f IS NOT NULL", False),
    "inner_join": ("SELECT t.id, d.label FROM t JOIN d ON t.k = d.k "
                   "WHERE t.v > 0", False),
    "left_join": ("SELECT t.id, d.label FROM t LEFT JOIN d ON t.k = d.k",
                  False),
    "string_group": ("SELECT s, COUNT(*) FROM t GROUP BY s", False),
    "order_by_multi_key": ("SELECT id FROM t WHERE k IS NOT NULL AND v IS "
                           "NOT NULL ORDER BY k ASC, v DESC, id ASC LIMIT 50",
                           True),
    "distinct": ("SELECT DISTINCT k FROM t", False),
    "window_row_number": ("SELECT id, ROW_NUMBER() OVER (PARTITION BY k "
                          "ORDER BY v ASC, id ASC) FROM t WHERE k IS NOT NULL "
                          "AND v IS NOT NULL ORDER BY id", True),
}


def make_table_dicts(seed=0, n=500, m=60):
    """(t, d) as column lists, None for NULL."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 25, n).tolist()
    v = rng.integers(-1000, 1000, n).tolist()
    f = np.round(rng.normal(0, 100, n), 3).tolist()
    s = rng.choice(["alpha", "beta", "gamma", "delta", None], n,
                   p=[0.3, 0.3, 0.2, 0.1, 0.1]).tolist()
    for i in rng.choice(n, n // 10, replace=False):
        k[i] = None
    for i in rng.choice(n, n // 10, replace=False):
        v[i] = None
    t = {"id": list(range(n)), "k": k, "v": v, "f": f, "s": s}
    d = {"k": [i % 30 for i in range(m)],
         "label": [f"L{i % 7}" for i in range(m)]}
    return t, d


def null_safe_sorted(rows):
    return sorted(rows, key=lambda r: tuple(
        (x is None, "" if x is None else str(type(x)),
         x if x is not None else 0) for x in r))


def rows_in_order(rows, ordered):
    """The rows as compared: as given for an ORDER BY case, else sorted."""
    rows = [tuple(r) for r in rows]
    return rows if ordered else null_safe_sorted(rows)


def _equal(a, b):
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        return math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0)
    return a == b and type(a) is type(b)


def same(got, want):
    assert len(got) == len(want), (len(got), len(want), got[:3], want[:3])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(map(_equal, g, w)), (g, w)
