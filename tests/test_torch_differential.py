"""tests/test_differential.py's nine cases through the port's
`Session(device="cpu")`, with the compiled pipeline on (the default),
beside the JAX package's Session and pandas, on `make_tables()`' 500 rows
with NULLs, strings and duplicate keys: integers and strings exactly,
floats to rtol 1e-9. The card's variant is
tests/test_torch_differential_cuda.py.
"""

import pandas as pd
import pytest

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session

import test_differential as D
from torch_differential_cases import (
    CASES, make_table_dicts, null_safe_sorted, rows_in_order, same,
)


def _pd(rows):
    return null_safe_sorted([tuple(
        None if pd.isna(x) else int(x) if isinstance(x, D.np.integer)
        else float(x) if isinstance(x, (D.np.floating, float)) else x
        for x in r) for r in rows])


def _groupby(t, d):
    out = []
    for k, grp in t.groupby("k", dropna=False):
        sv = grp.v.dropna()
        out.append((None if pd.isna(k) else int(k), len(grp),
                    int(sv.count()),
                    int(sv.sum()) if len(sv) else None,
                    int(sv.min()) if len(sv) else None,
                    int(sv.max()) if len(sv) else None))
    return null_safe_sorted(out)


def _order_by(t, d):
    tt = t.dropna(subset=["k", "v"]).sort_values(
        ["k", "v", "id"], ascending=[True, False, True]).head(50)
    return [(int(i),) for i in tt.id]


def _row_number(t, d):
    tt = t.dropna(subset=["k", "v"]).copy()
    tt["rn"] = tt.sort_values(["v", "id"]).groupby("k").cumcount() + 1
    return [(int(r.id), int(r.rn)) for r in tt.sort_values("id").itertuples()]


# pandas' rows for each case, in the form `rows_in_order` gives
PANDAS = {
    "filter": lambda t, d: _pd(
        t[(t.v > 250) & (t.k < 10)][["id"]].itertuples(index=False)),
    "groupby": _groupby,
    "avg_float": lambda t, d: [(float(t.f.mean()),)],
    "inner_join": lambda t, d: _pd(
        t[t.v > 0].merge(d, on="k")[["id", "label"]].itertuples(index=False)),
    "left_join": lambda t, d: _pd(
        t.merge(d, on="k", how="left")[["id", "label"]]
        .itertuples(index=False)),
    "string_group": lambda t, d: null_safe_sorted(
        [(None if pd.isna(k) else k, int(c))
         for k, c in t.groupby("s", dropna=False).size().items()]),
    "order_by_multi_key": _order_by,
    "distinct": lambda t, d: null_safe_sorted(
        [(None if pd.isna(k) else int(k),) for k in t.k.unique()]),
    "window_row_number": _row_number,
}


def _register(s, t, d):
    s.register_table("t", t)
    s.register_table("d", d)
    return s


@pytest.fixture(scope="module")
def env():
    t, d = make_table_dicts()
    return (_register(Session(device="cpu"), t, d),
            _register(JSession(), t, d), *D.make_tables())


def test_tables_are_make_tables():
    """The port's tables (no pandas) hold test_differential's rows."""
    t, d = make_table_dicts()
    pt, pdim = D.make_tables()
    for c in pt.columns:
        assert t[c] == [None if pd.isna(x) else
                        int(x) if c in ("id", "k", "v") else x
                        for x in pt[c]], c
    assert d == {"k": pdim["k"].tolist(), "label": pdim["label"].tolist()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case(case, env):
    port, jax, t, d = env
    sql, ordered = CASES[case]
    st = dict(port.executor.pipeline.stats)
    got = rows_in_order(port.sql(sql).to_pylist(), ordered)
    ran = {k: port.executor.pipeline.stats[k] - st[k]
           for k in ("compiles", "hits", "fallbacks")}
    assert ran["compiles"] + ran["hits"] >= 1 and not ran["fallbacks"], ran
    same(got, rows_in_order(jax.sql(sql).to_pylist(), ordered))
    same(got, PANDAS[case](t, d))
