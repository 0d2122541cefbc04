"""TPC-H's refresh functions over the tables of `data.generate`, and the
statements of `chip_smoke.py`'s phase 11 (the Session surface at SF1).

TPC-H v3.0.1 §2.5 defines the data-maintenance workload: RF1 inserts new
sales (SF x 1,500 orders with keys above the current largest, each with 1
to 7 lineitems, §2.5.2) and RF2 deletes old ones (the SF x 1,500 orders
with the lowest keys and their lineitems, §2.5.3). `make_rf1` draws a
refresh set column by column as `data.generate` draws its table (the same
ranges and option lists, from its own seed); the keys run on from the
largest present key, so a new order's row index in the oracle's tables is
its key, as `oracle.py` needs.

`State` is the oracle's side: the host tables of `data.generate` with each
statement's edit applied in numpy. An order that RF2 deletes stays as a
row of `orders` with no lineitem (`State.deleted` marks it): every oracle
this module runs reads orders through lineitem (Q1, Q3, Q10, Q15, Q18) or
through `orders_rows`, which skips deleted orders. Edits make new arrays,
never write old ones, so a copy of a State is a snapshot (BEGIN,
SAVEPOINT).

`steps(state, seed)` yields phase 11's statements M1-M12 in order: each
with its SQL, parameters, the rows it must give (computed from the state
before its edit) and its edit.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from query_engine_tpu_torch.tpch import oracle
from query_engine_tpu_torch.tpch.data import (
    EPOCH, SF1_LINEITEM, HostTable, _pick, days,
)
from query_engine_tpu_torch.tpch.queries import QUERIES

ORDERS_PER_SF = 1500  # TPC-H §2.5.2: SF x 1,500 orders a refresh
MIN_REFRESH = 16      # at the tests' sizes, still a few orders
VALUES_ORDERS = 10    # RF1's first orders go in as one INSERT ... VALUES
UPSERT_ROWS = 100     # M9: half existing customer keys, half new

PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
O_COMMENTS = ["deposits nag", "special packages requests",
              "furious accounts", "special asymptotes requests wake",
              "quiet ideas"]
SHIPMODES = ["MAIL", "SHIP", "AIR", "TRUCK", "RAIL", "FOB", "REG AIR"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]


def refresh_count(n_li: int) -> int:
    """Orders a refresh inserts or deletes at `n_li` lineitem rows."""
    return max(round(n_li / SF1_LINEITEM * ORDERS_PER_SF), MIN_REFRESH)


# ---- host tables ---------------------------------------------------------

def concat(a: HostTable, b: HostTable) -> HostTable:
    """a's rows then b's, string columns on their merged dictionary."""
    cols, dicts = {}, {}
    for f in a.fields:
        x, y = a.columns[f.name], b.columns[f.name]
        if f.name in a.dicts:
            merged = np.union1d(a.dicts[f.name], b.dicts[f.name])
            x = np.searchsorted(merged, a.dicts[f.name])[x].astype(np.int32)
            y = np.searchsorted(merged, b.dicts[f.name])[y].astype(np.int32)
            dicts[f.name] = merged
        cols[f.name] = np.concatenate([x, y.astype(x.dtype)])
    return HostTable(a.name, list(a.fields), cols, dicts,
                     a.num_rows + b.num_rows)


def take(t: HostTable, rows: np.ndarray) -> HostTable:
    """The rows `rows` of t (dictionaries kept)."""
    return HostTable(t.name, list(t.fields),
                     {k: v[rows] for k, v in t.columns.items()},
                     dict(t.dicts), len(rows))


def with_column(t: HostTable, name: str, values: np.ndarray) -> HostTable:
    cols = dict(t.columns)
    cols[name] = values
    return HostTable(t.name, list(t.fields), cols, dict(t.dicts), t.num_rows)


@dataclass
class State:
    """The oracle's tables and the orders RF2 deleted (by key)."""

    tables: Dict[str, HostTable]
    deleted: np.ndarray = None
    saved: List["State"] = field(default_factory=list)

    def __post_init__(self):
        if self.deleted is None:
            self.deleted = np.zeros(self.tables["orders"].num_rows, bool)

    def snapshot(self) -> "State":
        return State(dict(self.tables), self.deleted.copy())

    def restore(self, snap: "State") -> None:
        self.tables, self.deleted = dict(snap.tables), snap.deleted.copy()

    def live_keys(self) -> np.ndarray:
        return np.nonzero(~self.deleted)[0]


@dataclass
class RefreshSet:
    orders: HostTable
    lineitem: HostTable


def make_rf1(state: State, count: int, seed: int) -> RefreshSet:
    """RF1's new orders and their lineitems, drawn as data.generate draws
    orders and lineitem; keys from the largest key + 1 on."""
    t = state.tables
    rng = np.random.default_rng(seed)
    n_cust = t["customer"].num_rows
    n_supp, n_part = t["supplier"].num_rows, t["part"].num_rows
    first = t["orders"].num_rows
    keys = np.arange(first, first + count, dtype=np.int64)
    o_date = rng.integers(days(1992, 1, 1), days(1998, 8, 2), count)
    orders = HostTable("orders", list(t["orders"].fields), {}, {}, count)
    cols = {
        "o_orderkey": keys,
        "o_custkey": rng.integers(0, max(2 * n_cust // 3, 1), count),
        "o_orderdate": o_date,
        "o_shippriority": np.zeros(count, dtype=np.int64),
        "o_totalprice": np.round(rng.uniform(900.0, 500000.0, count), 2),
    }
    for name, options in (("o_orderpriority", PRIORITIES),
                          ("o_comment", O_COMMENTS)):
        codes, d = _pick(rng.integers(0, len(options), count), options)
        cols[name], orders.dicts[name] = codes, d
    orders.columns = cols
    per = rng.integers(1, 8, count)  # 1-7 lineitems an order
    n = int(per.sum())
    okey = np.repeat(keys, per)
    odate = np.repeat(o_date, per)
    ship = odate + rng.integers(1, 122, n)
    li = HostTable("lineitem", list(t["lineitem"].fields), {}, {}, n)
    lcols = {
        "l_orderkey": okey,
        "l_suppkey": rng.integers(0, n_supp, n),
        "l_partkey": rng.integers(0, n_part, n),
        "l_quantity": rng.integers(1, 51, n),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n), 2),
        "l_shipdate": ship,
        "l_commitdate": odate + rng.integers(30, 91, n),
        "l_receiptdate": ship + rng.integers(1, 31, n),
    }
    for name, options in (("l_shipmode", SHIPMODES),
                          ("l_returnflag", ["A", "N", "R"]),
                          ("l_linestatus", ["O", "F"])):
        codes, d = _pick(rng.integers(0, len(options), n), options)
        lcols[name], li.dicts[name] = codes, d
    li.columns = lcols
    return RefreshSet(orders, li)


def apply_rf1(state: State, rf: RefreshSet) -> None:
    t = dict(state.tables)
    t["orders"] = concat(t["orders"], rf.orders)
    t["lineitem"] = concat(t["lineitem"], rf.lineitem)
    state.tables = t
    state.deleted = np.concatenate(
        [state.deleted, np.zeros(rf.orders.num_rows, bool)])


def rf2_keys(state: State, count: int) -> np.ndarray:
    """RF2's orders: the `count` lowest present keys."""
    return state.live_keys()[:count]


def apply_rf2(state: State, keys: np.ndarray) -> None:
    t = dict(state.tables)
    li = t["lineitem"]
    gone = np.zeros(len(state.deleted), bool)
    gone[keys] = True
    t["lineitem"] = take(li, np.nonzero(~gone[li.columns["l_orderkey"]])[0])
    state.tables = t
    state.deleted = state.deleted | gone


def rf2_lineitems(state: State, keys: np.ndarray) -> int:
    gone = np.zeros(len(state.deleted), bool)
    gone[keys] = True
    return int(gone[state.tables["lineitem"].columns["l_orderkey"]].sum())


# ---- statements ----------------------------------------------------------

def _sql_value(v, kind: str) -> str:
    if kind == "date":
        return f"DATE '{EPOCH + datetime.timedelta(days=int(v))}'"
    if kind == "str":
        return "'" + str(v).replace("'", "''") + "'"
    if kind == "float":
        return repr(float(v))
    return str(int(v))


def values_sql(table: str, t: HostTable, rows: Sequence[int],
               tail: str = "") -> str:
    """INSERT INTO table VALUES (...), ... of rows of t, in t's column
    order, dates as DATE '...' literals."""
    kinds = []
    for f in t.fields:
        k = f.data_type.kind.value
        kinds.append("str" if f.name in t.dicts else "date" if k == "Date32"
                     else "float" if k.startswith("Float") else "int")
    tuples = []
    for r in rows:
        vals = []
        for f, k in zip(t.fields, kinds):
            v = t.columns[f.name][r]
            vals.append(_sql_value(t.dicts[f.name][v] if k == "str" else v,
                                   k))
        tuples.append("(" + ", ".join(vals) + ")")
    return f"INSERT INTO {table} VALUES " + ", ".join(tuples) + tail


def in_list(column: str, keys: Sequence[int]) -> str:
    return f"{column} IN ({', '.join(str(int(k)) for k in keys)})"


Q6_PARAM = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM "
            "lineitem WHERE l_shipdate >= $1 AND l_shipdate < CAST($1 AS "
            "DATE) + INTERVAL '1 year' AND l_discount BETWEEN $2 - 0.01 AND "
            "$2 + 0.01 AND l_quantity < $3")
Q6_PARAMS = ["1994-01-01", 0.06, 24]

ORDER_BY_KEY = ("SELECT o_orderkey, o_custkey, o_orderdate, o_totalprice "
                "FROM orders WHERE o_orderkey = $1")
ORDERS_IN_RANGE = ("SELECT o_orderkey, o_orderpriority FROM orders WHERE "
                   "o_orderkey >= $1 AND o_orderkey < $2 ORDER BY o_orderkey")

# TPC-H §2.4.15's view form of Q15 (its join written with JOIN ... ON)
Q15_SCRIPT = (
    "CREATE VIEW revenue0 (supplier_no, total_revenue) AS SELECT l_suppkey, "
    "SUM(l_extendedprice * (1 - l_discount)) FROM lineitem WHERE "
    "l_shipdate >= DATE '1996-01-01' AND l_shipdate < DATE '1996-01-01' + "
    "INTERVAL '3 months' GROUP BY l_suppkey; "
    "SELECT s_suppkey, s_name, total_revenue FROM supplier JOIN revenue0 ON "
    "s_suppkey = supplier_no WHERE total_revenue = (SELECT MAX(total_revenue) "
    "FROM revenue0) ORDER BY s_suppkey; "
    "DROP VIEW revenue0"
)

AFTER_REFRESH = ("Q1", "Q3", "Q18")


def q6_rows(tables: Dict[str, HostTable], start: str, discount: float,
            quantity: int) -> list:
    """The rows of Q6_PARAM with $1-$3 = start (an ISO date), discount,
    quantity."""
    li = oracle._T(tables["lineitem"])
    y, m, d = (int(x) for x in start.split("-"))
    m = (li.l_shipdate >= days(y, m, d)) \
        & (li.l_shipdate < days(y + 1, m, d)) \
        & (li.l_discount >= discount - 0.01) \
        & (li.l_discount <= discount + 0.01) & (li.l_quantity < quantity)
    return [(oracle._global_sum(li.l_extendedprice[m] * li.l_discount[m]),)]


def q6_param_rows(state: State) -> list:
    return q6_rows(state.tables, *Q6_PARAMS)


def orders_rows(state: State, lo: int, hi: int, cols: Sequence[str]) -> list:
    """Present orders with lo <= key < hi, by key: `cols` as to_pylist
    gives them."""
    o = state.tables["orders"]
    keys = [k for k in range(max(lo, 0), min(hi, o.num_rows))
            if not state.deleted[k]]
    out = []
    for k in keys:
        row = []
        for c in cols:
            v = o.columns[c][k]
            if c in o.dicts:
                row.append(str(o.dicts[c][v]))
            elif c == "o_orderdate":
                row.append(EPOCH + datetime.timedelta(days=int(v)))
            elif c == "o_totalprice":
                row.append(float(v))
            else:
                row.append(int(v))
        out.append(tuple(row))
    return out


def upsert_set(state: State, seed: int) -> HostTable:
    """M9's rows: UPSERT_ROWS // 2 existing customer keys (drawn) and as
    many new keys from the largest + 1 on, interleaved, every column drawn
    as data.generate draws customer's."""
    c = state.tables["customer"]
    rng = np.random.default_rng(seed)
    half = UPSERT_ROWS // 2
    old = rng.choice(c.num_rows, half, replace=False)
    new = np.arange(c.num_rows, c.num_rows + half)
    keys = np.empty(2 * half, dtype=np.int64)
    keys[0::2], keys[1::2] = old, new
    n = len(keys)
    t = HostTable("customer", list(c.fields), {}, {}, n)
    seg, seg_d = _pick(rng.integers(0, len(SEGMENTS), n), SEGMENTS)
    names = np.asarray([f"Customer#{k:09d}" for k in keys], dtype=object)
    phones = np.asarray([
        f"{cc}-{a}-{b}-{d}" for cc, a, b, d in zip(
            rng.integers(10, 35, n), rng.integers(100, 999, n),
            rng.integers(100, 999, n), rng.integers(1000, 9999, n))],
        dtype=object)
    name_d, name_c = np.unique(names, return_inverse=True)
    phone_d, phone_c = np.unique(phones, return_inverse=True)
    t.columns = {
        "c_custkey": keys,
        "c_nationkey": rng.integers(0, 25, n),
        "c_mktsegment": seg,
        "c_name": name_c.astype(np.int32),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
        "c_phone": phone_c.astype(np.int32),
    }
    t.dicts = {"c_mktsegment": seg_d, "c_name": name_d, "c_phone": phone_d}
    return t


def apply_upsert(state: State, rows: HostTable) -> None:
    c = state.tables["customer"]
    keys = rows.columns["c_custkey"]
    hit = keys < c.num_rows
    bal = c.columns["c_acctbal"].copy()
    bal[keys[hit]] = 0.0
    c = with_column(c, "c_acctbal", bal)
    t = dict(state.tables)
    t["customer"] = concat(c, take(rows, np.nonzero(~hit)[0]))
    state.tables = t


def apply_acctbal_update(state: State) -> int:
    c = state.tables["customer"]
    m = oracle._T(c).is_("c_mktsegment", "BUILDING")
    bal = np.where(m, c.columns["c_acctbal"] * 1.01, c.columns["c_acctbal"])
    t = dict(state.tables)
    t["customer"] = with_column(c, "c_acctbal", bal)
    state.tables = t
    return int(m.sum())


@dataclass
class Step:
    """One statement of phase 11: `want(state)` gives its rows from the
    state before `edit(state)` applies the statement to the oracle."""

    label: str
    sql: str
    params: Optional[list] = None
    want: Optional[Callable[[State], list]] = None
    edit: Optional[Callable[[State], None]] = None
    float_keys: Sequence[int] = ()
    script: bool = False  # run through Session.sql_script
    index_scan: bool = False  # its plan holds a PIndexScan


def _status(tag: str):
    return lambda state: [(tag,)]


def _query(q: str, label: str) -> Step:
    return Step(label, QUERIES[q], want=lambda st: oracle.run(q, st.tables),
                float_keys=oracle.FLOAT_SORT_KEYS.get(q, ()))


def index_steps(state: State, label: str) -> List[Step]:
    """M2: an equality and a range lookup on orders_pk, with parameters."""
    live = state.live_keys()
    k = int(live[len(live) // 3])
    lo = int(live[0])
    return [
        Step(label, ORDER_BY_KEY, [k], index_scan=True,
             want=lambda st: orders_rows(
                 st, k, k + 1, ("o_orderkey", "o_custkey", "o_orderdate",
                                "o_totalprice"))),
        Step(label, ORDERS_IN_RANGE, [lo - 3, lo + 40], index_scan=True,
             want=lambda st: orders_rows(st, lo - 3, lo + 40,
                                         ("o_orderkey", "o_orderpriority"))),
    ]


def rf1_steps(state: State, rf: RefreshSet, label: str) -> List[Step]:
    """RF1: the first orders as INSERT ... VALUES ... RETURNING, the rest
    and the lineitems as INSERT ... SELECT from the staging tables
    orders_rf1 and lineitem_rf1 (registered by the caller from
    `staging(rf)`)."""
    nv = min(VALUES_ORDERS, rf.orders.num_rows)
    keys = rf.orders.columns["o_orderkey"]
    n_li = rf.lineitem.num_rows
    return [
        Step(label, values_sql("orders", rf.orders, range(nv),
                               " RETURNING o_orderkey"),
             want=lambda st: [(int(k),) for k in keys[:nv]]),
        Step(label, "INSERT INTO orders SELECT * FROM orders_rf1",
             want=_status(f"INSERT 0 {rf.orders.num_rows - nv}")),
        Step(label, "INSERT INTO lineitem SELECT * FROM lineitem_rf1",
             want=_status(f"INSERT 0 {n_li}"),
             edit=lambda st: apply_rf1(st, rf)),
    ]


def staging(rf: RefreshSet) -> Dict[str, HostTable]:
    """The staging tables of RF1's INSERT ... SELECTs: the orders after the
    ones inserted by VALUES, and every lineitem."""
    nv = min(VALUES_ORDERS, rf.orders.num_rows)
    return {"orders_rf1": take(rf.orders, np.arange(nv, rf.orders.num_rows)),
            "lineitem_rf1": rf.lineitem}


def rf2_steps(state: State, keys: np.ndarray, label: str) -> List[Step]:
    return [
        Step(label, "DELETE FROM lineitem WHERE " + in_list("l_orderkey",
                                                            keys),
             want=lambda st: [(f"DELETE {rf2_lineitems(st, keys)}",)]),
        Step(label, "DELETE FROM orders WHERE " + in_list("o_orderkey", keys),
             want=_status(f"DELETE {len(keys)}"),
             edit=lambda st: apply_rf2(st, keys)),
    ]


def q1_summary_rows(state: State) -> list:
    """M12's CTAS of Q1 with its added all-NULL column."""
    return [r + (None,) for r in oracle.run("Q1", state.tables)]


def steps(state: State, count: int, seed: int,
          rf: RefreshSet) -> Iterator[Step]:
    """M1-M9 in order. `rf` is M4's refresh set (its staging tables
    registered by the caller). Each step's parameters and rows are made
    when the generator reaches it, after the edits of the steps before."""
    yield Step("M1", "CREATE INDEX orders_pk ON orders (o_orderkey)",
               want=_status("CREATE INDEX"))
    yield from index_steps(state, "M2")
    yield Step("M3", Q6_PARAM, list(Q6_PARAMS), want=q6_param_rows)
    yield from rf1_steps(state, rf, "M4")
    for q in AFTER_REFRESH:
        yield _query(q, "M5")
    keys = rf2_keys(state, count)
    yield from rf2_steps(state, keys, "M6")
    yield from index_steps(state, "M6")
    for q in AFTER_REFRESH:
        yield _query(q, "M7")
    yield Step("M8", "UPDATE customer SET c_acctbal = c_acctbal * 1.01 "
               "WHERE c_mktsegment = 'BUILDING'",
               want=lambda st: [(
                   f"UPDATE {int(oracle._T(st.tables['customer']).is_('c_mktsegment', 'BUILDING').sum())}",)],
               edit=apply_acctbal_update)
    yield _query("Q10", "M8")
    ups = upsert_set(state, seed + 1)
    yield Step("M9", values_sql("customer", ups, range(ups.num_rows),
                                " ON CONFLICT (c_custkey) DO UPDATE SET "
                                "c_acctbal = 0.0"),
               want=_status(f"INSERT 0 {ups.num_rows}"),
               edit=lambda st: apply_upsert(st, ups))
    yield Step("M9", "SELECT c_custkey, c_acctbal FROM customer WHERE "
               + in_list("c_custkey", ups.columns["c_custkey"])
               + " ORDER BY c_custkey",
               want=lambda st: sorted(
                   (int(k), float(st.tables["customer"].columns["c_acctbal"][k]))
                   for k in ups.columns["c_custkey"]))
    yield _query("Q10", "M9")


def ddl_steps(state: State) -> Iterator[Step]:
    """M11 (Q15's view form through sql_script) and M12 (CREATE TABLE AS,
    ALTER TABLE, DROP TABLE, TRUNCATE of a staging table)."""
    yield Step("M11", Q15_SCRIPT, script=True,
               want=lambda st: [("CREATE VIEW",)] + oracle.run(
                   "Q15", st.tables) + [("DROP VIEW",)])
    yield Step("M12", "CREATE TABLE q1_summary AS " + QUERIES["Q1"],
               want=lambda st: [(f"SELECT {len(oracle.run('Q1', st.tables))}",)])
    yield Step("M12", "ALTER TABLE q1_summary ADD COLUMN note VARCHAR",
               want=_status("ALTER TABLE"))
    yield Step("M12", "ALTER TABLE q1_summary RENAME COLUMN n TO n_rows",
               want=_status("ALTER TABLE"))
    yield Step("M12", "SELECT * FROM q1_summary ORDER BY l_returnflag, "
               "l_linestatus", want=q1_summary_rows)
    yield Step("M12", "SELECT l_returnflag, n_rows FROM q1_summary WHERE "
               "note IS NULL ORDER BY n_rows DESC LIMIT 2",
               want=lambda st: sorted(
                   ((r[0], r[7]) for r in oracle.run("Q1", st.tables)),
                   key=lambda x: -x[1])[:2])
    yield Step("M12", "DROP TABLE q1_summary", want=_status("DROP TABLE"))
    yield Step("M12", "TRUNCATE TABLE orders_rf1",
               want=_status("TRUNCATE TABLE"))
    yield Step("M12", "SELECT COUNT(*) FROM orders_rf1",
               want=_status_count(0))


def _status_count(n: int):
    return lambda state: [(n,)]


def transaction_steps(state: State, count: int, seed: int,
                      rf: RefreshSet) -> Iterator[Step]:
    """M10: BEGIN; a second RF1 (`rf`, staged by the caller); SAVEPOINT s;
    a second RF2; ROLLBACK TO s; Q1; ROLLBACK; Q1."""

    def begin(st):
        st.saved.append(st.snapshot())

    def rollback_to(st):
        st.restore(st.saved[-1])

    def rollback(st):
        st.restore(st.saved[0])
        st.saved.clear()

    yield Step("M10", "BEGIN", want=_status("BEGIN"), edit=begin)
    yield from rf1_steps(state, rf, "M10")
    yield Step("M10", "SAVEPOINT s", want=_status("SAVEPOINT"), edit=begin)
    keys = rf2_keys(state, count)
    yield from rf2_steps(state, keys, "M10")
    yield Step("M10", "ROLLBACK TO s", want=_status("ROLLBACK"),
               edit=rollback_to)
    yield _query("Q1", "M10")
    yield Step("M10", "ROLLBACK", want=_status("ROLLBACK"), edit=rollback)
    yield _query("Q1", "M10")


def run_step(session, step: Step) -> list:
    """The step's rows through `session` (a script's results joined)."""
    if step.script:
        return [r for b in session.sql_script(step.sql) for r in b.to_pylist()]
    return session.sql(step.sql, step.params).to_pylist()


def register_staging(session, rf: RefreshSet) -> None:
    """Register (or register anew) RF1's staging tables with `session`."""
    for name, t in staging(rf).items():
        session.register_table(name, t.to_batch(session.device))
