"""The TPC-H tables of `benchmarks/tpch_mini.build(n_li)`, as numpy planes.

`generate(n_li)` makes the same random draws, in the same order and from the
same seed, as the JAX package's `tpch_mini.build`, so every value, validity
bit and dictionary is identical. It works on numpy arrays throughout: a
string column drawn with `rng.choice(options, n)` is drawn as the codes
`rng.integers(0, len(options), n)` (the same draws), then remapped to its
sorted dictionary, so no Python list of millions of strings is made. The
one column drawn element by element, `c_phone`, keeps its per-customer
draws, since vectorizing them would change the stream.

`n_li = SF1_LINEITEM` is TPC-H scale factor 1's lineitem count (TPC-H
specification v3.0.1, 4.2.5). With tpch_mini's ratios, lineitem, orders and
customer have SF1's cardinalities; supplier (15,003 rows) and part (300,060)
are 1.5x SF1's and partsupp (600,120, two suppliers per part) is 0.75x.
`n_li = SF10_LINEITEM` is scale factor 10's lineitem count (the same
table of the specification), with the same ratios: orders 14,996,513 rows
(capacity 2^24), lineitem at capacity 2^26.

    tables = generate(1 << 11)
    session = Session(device="cuda")
    register(session, tables)
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from query_engine_tpu_torch.columnar.batch import ColumnBatch, padded_capacity
from query_engine_tpu_torch.columnar.convert import from_numpy_batch
from query_engine_tpu_torch.core.schema import Field
from query_engine_tpu_torch.core.types import DataType

SEED = 19920521
SF1_LINEITEM = 6_001_215
SF10_LINEITEM = 59_986_052
EPOCH = datetime.date(1970, 1, 1)


def days(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 (a DATE32 value)."""
    return (datetime.date(y, m, d) - EPOCH).days


@dataclass
class HostTable:
    """One table on the host: live rows only, strings as int32 codes into
    the sorted dictionary of that column."""

    name: str
    fields: List[Field]
    columns: Dict[str, np.ndarray]
    dicts: Dict[str, np.ndarray]
    num_rows: int

    def code(self, column: str, value: str) -> int:
        """The code of `value` in a string column, or -1 if absent."""
        d = self.dicts[column]
        i = int(np.searchsorted(d, value))
        return i if i < len(d) and d[i] == value else -1

    def to_batch(self, device) -> ColumnBatch:
        n = self.num_rows
        cap = padded_capacity(n)
        valid = np.arange(cap) < n
        planes = []
        for f in self.fields:
            src = self.columns[f.name]
            data = np.zeros(cap, dtype=f.data_type.device_dtype)
            data[:n] = src
            planes.append((data, valid, self.dicts.get(f.name)))
        return from_numpy_batch(self.fields, planes, n, device)


def _strings(values: Sequence[str]):
    """(int32 codes, sorted dictionary) of a list of strings."""
    uniq, codes = np.unique(np.asarray(values, dtype=object),
                            return_inverse=True)
    return codes.astype(np.int32), uniq


def _pick(raw: np.ndarray, options: Sequence[str]):
    """(int32 codes, sorted dictionary) of options[raw]: the dictionary
    holds only the options drawn, as a dictionary built from the values
    would."""
    vals = np.asarray(options, dtype=object)
    used = np.nonzero(np.bincount(raw, minlength=len(vals)))[0]
    order = np.argsort(vals[used], kind="stable")
    remap = np.zeros(len(vals), dtype=np.int32)
    remap[used[order]] = np.arange(len(used), dtype=np.int32)
    return remap[raw], vals[used][order]


class _NewTable:
    def __init__(self, name: str, n: int):
        self.t = HostTable(name, [], {}, {}, n)

    def num(self, name: str, values: np.ndarray, dtype: DataType):
        self.t.fields.append(Field(name, dtype))
        self.t.columns[name] = values
        return self

    def text(self, name: str, coded):
        codes, dictionary = coded
        self.t.fields.append(Field(name, DataType.utf8()))
        self.t.columns[name] = codes
        self.t.dicts[name] = dictionary
        return self


def generate(n_li: int) -> Dict[str, HostTable]:
    """The eight tables at `n_li` lineitem rows, keyed by table name."""
    rng = np.random.default_rng(SEED)
    n_ord = max(n_li // 4, 64)
    n_cust = max(n_ord // 10, 16)
    n_supp = max(n_ord // 100, 8)
    n_part = max(n_li // 20, 16)
    n_nation, n_region = 25, 5
    i64, f64, date = DataType.int64(), DataType.float64(), DataType.date32()

    def uniform(lo, hi, n):
        return np.round(rng.uniform(lo, hi, n), 2)

    def choice(options, n):
        return _pick(rng.integers(0, len(options), n), options)

    region = (
        _NewTable("region", n_region)
        .num("r_regionkey", np.arange(n_region), i64)
        .text("r_name", _strings(["AFRICA", "AMERICA", "ASIA", "EUROPE",
                                  "MIDDLE EAST"]))
    )
    nation = (
        _NewTable("nation", n_nation)
        .num("n_nationkey", np.arange(n_nation), i64)
        .text("n_name", _strings([f"NATION{i:02d}" for i in range(n_nation)]))
        .num("n_regionkey", np.arange(n_nation) % n_region, i64)
    )
    supp = (
        _NewTable("supplier", n_supp)
        .num("s_suppkey", np.arange(n_supp), i64)
        .num("s_nationkey", rng.integers(0, n_nation, n_supp), i64)
        .text("s_name", _strings([f"Supplier#{i:09d}" for i in range(n_supp)]))
        .num("s_acctbal", uniform(-999.99, 9999.99, n_supp), f64)
        .text("s_address", _strings([f"addr {i}" for i in range(n_supp)]))
        .text("s_comment", choice([
            "quick deliveries", "Customer slow Complaints filed", "reliable",
            "pending audit", "bulk only",
        ], n_supp))
    )
    part_types = [
        "PROMO BURNISHED COPPER", "PROMO PLATED TIN", "STANDARD BRUSHED",
        "ECONOMY ANODIZED STEEL", "MEDIUM POLISHED NICKEL",
        "LARGE BRUSHED BRASS",
    ]
    part_names = [
        "green tomato", "forest lace", "blue steel", "green almond",
        "rosy peach", "forest green mint", "ivory snow", "misty plum",
    ]
    containers = ["SM CASE", "SM BOX", "MED BOX", "MED BAG", "LG CASE",
                  "LG BOX", "JUMBO PKG", "WRAP CASE"]
    part = (
        _NewTable("part", n_part)
        .num("p_partkey", np.arange(n_part), i64)
        .text("p_type", choice(part_types, n_part))
        .text("p_name", choice(part_names, n_part))
        .text("p_brand", _pick(rng.integers(11, 56, n_part) - 11,
                               [f"Brand#{b}" for b in range(11, 56)]))
        .num("p_size", rng.integers(1, 51, n_part), i64)
        .text("p_container", choice(containers, n_part))
        .text("p_mfgr", _pick(rng.integers(1, 6, n_part) - 1,
                              [f"Manufacturer#{m}" for m in range(1, 6)]))
    )
    # every part stocked by 2 suppliers (deterministic spread)
    ps_part = np.repeat(np.arange(n_part), 2)
    ps_supp = (ps_part * 7 + np.tile(np.array([0, 3]), n_part)) % n_supp
    partsupp = (
        _NewTable("partsupp", 2 * n_part)
        .num("ps_partkey", ps_part, i64)
        .num("ps_suppkey", ps_supp, i64)
        .num("ps_availqty", rng.integers(1, 10000, 2 * n_part), i64)
        .num("ps_supplycost", uniform(1.0, 1000.0, 2 * n_part), f64)
    )
    cust = (
        _NewTable("customer", n_cust)
        .num("c_custkey", np.arange(n_cust), i64)
        .num("c_nationkey", rng.integers(0, n_nation, n_cust), i64)
        .text("c_mktsegment", choice(
            ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"],
            n_cust))
        .text("c_name", _strings([f"Customer#{i:09d}" for i in range(n_cust)]))
        .num("c_acctbal", uniform(-999.99, 9999.99, n_cust), f64)
    )
    # three scalar draws per customer, after the country codes
    cust.text("c_phone", _strings([
        f"{cc}-{rng.integers(100, 999)}-{rng.integers(100, 999)}-"
        f"{rng.integers(1000, 9999)}"
        for cc in rng.integers(10, 35, n_cust)
    ]))
    o_date = rng.integers(days(1992, 1, 1), days(1998, 8, 2), n_ord)
    orders = (
        _NewTable("orders", n_ord)
        .num("o_orderkey", np.arange(n_ord), i64)
        # the top third of custkeys place no orders (as in TPC-H)
        .num("o_custkey", rng.integers(0, max(2 * n_cust // 3, 1), n_ord), i64)
        .num("o_orderdate", o_date, date)
        .num("o_shippriority", np.zeros(n_ord, dtype=np.int64), i64)
        .text("o_orderpriority", choice(
            ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"],
            n_ord))
        .num("o_totalprice", uniform(900.0, 500000.0, n_ord), f64)
        .text("o_comment", choice([
            "deposits nag", "special packages requests", "furious accounts",
            "special asymptotes requests wake", "quiet ideas",
        ], n_ord))
    )
    okey = rng.integers(0, n_ord, n_li)
    ship = o_date[okey] + rng.integers(1, 122, n_li)
    commit = o_date[okey] + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    li = (
        _NewTable("lineitem", n_li)
        .num("l_orderkey", okey, i64)
        .num("l_suppkey", rng.integers(0, n_supp, n_li), i64)
        .num("l_partkey", rng.integers(0, n_part, n_li), i64)
        .text("l_shipmode", choice(
            ["MAIL", "SHIP", "AIR", "TRUCK", "RAIL", "FOB", "REG AIR"], n_li))
        .num("l_quantity", rng.integers(1, 51, n_li), i64)
        .num("l_extendedprice", uniform(900, 105000, n_li), f64)
        .num("l_discount", uniform(0.0, 0.1, n_li), f64)
        .num("l_tax", uniform(0.0, 0.08, n_li), f64)
        .text("l_returnflag", choice(["A", "N", "R"], n_li))
        .text("l_linestatus", choice(["O", "F"], n_li))
        .num("l_shipdate", ship, date)
        .num("l_commitdate", commit, date)
        .num("l_receiptdate", receipt, date)
    )
    out = [cust, orders, li, supp, nation, region, part, partsupp]
    return {b.t.name: b.t for b in out}


def register(session, tables: Dict[str, HostTable]) -> None:
    """Register every table with `session`, its planes made on the
    session's device."""
    for name, t in tables.items():
        session.register_table(name, t.to_batch(session.device))
