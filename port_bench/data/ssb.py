"""The Star Schema Benchmark's tables, drawn from a seed on the device.

P. O'Neil, E. O'Neil, X. Chen, S. Revilak, "Star Schema Benchmark",
revision 3 (2009): one fact table, lineorder, and four dimensions. At scale
factor SF: customer 30,000 x SF rows, supplier 2,000 x SF, part 200,000 x
floor(1 + log2 SF), date 2,556 days from 1992-01-01, and lineorder with
TPC-H's order and line counts (1,500,000 x SF orders of 1 to 7 lines).
Keys start at 1, as dbgen's do; lo_orderdate and lo_commitdate are
d_datekey values (yyyymmdd). Every integer column is BIGINT, and money is
in integer cents, so every answer of the 13 queries is exact. The sizes and
the choices the paper leaves open are in the configuration file
(`configs/ssb-sf10.json`: `sizes`, `assumed`).
"""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np
import torch

from port_bench.data.common import Draw, digits, numbered, strings
from port_bench.tables import Table

# TPC-H's 25 nations with their region keys (TPC-H v3.0.1, 4.2.3)
NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECI", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
# TPC-H's 92 colors (4.2.3), for p_name and p_color
COLORS = ("almond antique aquamarine azure beige bisque black blanched blue "
          "blush brown burlywood burnished chartreuse chiffon chocolate "
          "coral cornflower cornsilk cream cyan dark deep dim dodger drab "
          "firebrick floral forest frosted gainsboro ghost goldenrod green "
          "grey honeydew hot indian ivory khaki lace lavender lawn lemon "
          "light lime linen magenta maroon medium metallic midnight mint "
          "misty moccasin navajo navy olive orange orchid pale papaya peach "
          "peru pink plum powder puff purple red rose rosy royal saddle "
          "salmon sandy seashell sienna sky slate smoke snow spring steel "
          "tan thistle tomato turquoise violet wheat white yellow").split()
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
MONTHS = ["January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December"]
WEEKDAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
            "Saturday", "Sunday"]
FIRST_DAY = datetime.date(1992, 1, 1)
N_DAYS = 2556


def _cities(nation_names):
    """City names of a nation, dbgen's way: the name's first 9 letters,
    padded with blanks, and a digit."""
    return [f"{n[:9]:<9}{k}" for n in nation_names for k in range(10)]


def _geography(d: Draw, n: int):
    """(city codes, city dictionary, nation, region) of n rows: a nation
    uniform over the 25, a city digit uniform over 10."""
    dev = d.device
    names = [nm for nm, _ in NATIONS]
    nat = d.ints(0, 25, n)
    city = nat * 10 + d.ints(0, 10, n)
    region_of = torch.tensor([r for _, r in NATIONS], device=dev)
    return (d.codes(city, _cities(names)), d.codes(nat, names),
            d.codes(region_of[nat], REGIONS), nat)


def _phones(nat: torch.Tensor, d: Draw) -> np.ndarray:
    n = len(nat)
    parts = [(nat + 10).cpu().numpy()] + [
        d.ints(lo, hi, n).cpu().numpy() for lo, hi in
        ((100, 1000), (100, 1000), (1000, 10000))]
    return strings([digits(parts[0], 2), b"-", digits(parts[1], 3), b"-",
                    digits(parts[2], 3), b"-", digits(parts[3], 4)])


def _unique_strings(values: np.ndarray, device):
    """(int32 codes, sorted dictionary) of per-row strings."""
    uniq, inv = np.unique(values, return_inverse=True)
    return torch.as_tensor(inv.astype(np.int32), device=device), uniq


def _lines_multiset(n_orders: int, n_rows: int, d: Draw) -> torch.Tensor:
    """Lines per order: counts 1..7 on equal shares of the orders, orders
    moved between counts 4 and 3 (or 4 and 5) until they sum to n_rows,
    then shuffled by the seed, so every seed has the same rows."""
    counts = np.full(7, n_orders // 7, dtype=np.int64)
    counts[: n_orders % 7] += 1
    total = int((counts * np.arange(1, 8)).sum())
    shift = n_rows - total
    if shift < 0:
        counts[3] += shift
        counts[2] -= shift
    else:
        counts[3] -= shift
        counts[4] += shift
    if counts.min() < 0:
        raise ValueError(f"{n_rows} lines cannot spread over {n_orders} "
                         "orders of 1-7 lines")
    lines = torch.repeat_interleave(
        torch.arange(1, 8, device=d.device),
        torch.as_tensor(counts, device=d.device))
    return d.shuffle(lines)


def _date_table(dev):
    rows = [FIRST_DAY + datetime.timedelta(days=i) for i in range(N_DAYS)]
    keys = [r.year * 10000 + r.month * 100 + r.day for r in rows]

    def last_in_month(r):
        return (r + datetime.timedelta(days=1)).month != r.month

    def season(r):
        if r.month == 12 or (r.month == 11 and r.day >= 25):
            return "Christmas"
        if r.month in (6, 7, 8):
            return "Summer"
        if r.month in (1, 2):
            return "Winter"
        if r.month in (3, 4, 5):
            return "Spring"
        return "Fall"

    holidays = {(1, 1), (7, 4), (12, 25), (12, 31), (11, 11), (5, 31)}

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int64, device=dev)

    def text(vals):
        uniq = sorted(set(vals))
        idx = {v: i for i, v in enumerate(uniq)}
        return (torch.tensor([idx[v] for v in vals], dtype=torch.int32,
                             device=dev), np.asarray(uniq, dtype=object))

    day_of_year = [r.timetuple().tm_yday for r in rows]
    t = (Table("date", N_DAYS)
         .add("d_datekey", "int64", ints(keys))
         .add("d_date", "utf8", *text([f"{MONTHS[r.month - 1]} {r.day}, "
                                       f"{r.year}" for r in rows]))
         .add("d_dayofweek", "utf8", *text([WEEKDAYS[r.weekday()]
                                            for r in rows]))
         .add("d_month", "utf8", *text([MONTHS[r.month - 1] for r in rows]))
         .add("d_year", "int64", ints([r.year for r in rows]))
         .add("d_yearmonthnum", "int64", ints([r.year * 100 + r.month
                                               for r in rows]))
         .add("d_yearmonth", "utf8", *text([f"{MONTHS[r.month - 1][:3]}"
                                            f"{r.year}" for r in rows]))
         .add("d_daynuminweek", "int64", ints([r.weekday() + 1
                                               for r in rows]))
         .add("d_daynuminmonth", "int64", ints([r.day for r in rows]))
         .add("d_daynuminyear", "int64", ints(day_of_year))
         .add("d_monthnuminyear", "int64", ints([r.month for r in rows]))
         .add("d_weeknuminyear", "int64", ints([(y - 1) // 7 + 1
                                                for y in day_of_year]))
         .add("d_sellingseason", "utf8", *text([season(r) for r in rows]))
         .add("d_lastdayinweekfl", "int64", ints([int(r.weekday() == 6)
                                                  for r in rows]))
         .add("d_lastdayinmonthfl", "int64", ints([int(last_in_month(r))
                                                   for r in rows]))
         .add("d_holidayfl", "int64", ints([int((r.month, r.day) in holidays)
                                            for r in rows]))
         .add("d_weekdayfl", "int64", ints([int(r.weekday() < 5)
                                            for r in rows])))
    return t


def generate(config: dict, seed: int, device) -> Dict[str, Table]:
    """lineorder and its four dimensions at the configuration's sizes."""
    d = Draw(seed, device)
    dev = d.device
    sizes = config["sizes"]
    n_cust, n_supp = int(sizes["customer"]), int(sizes["supplier"])
    n_part, n_ord = int(sizes["part"]), int(sizes["orders"])
    n_lo = int(sizes["lineorder"])

    def keys(n):
        return torch.arange(1, n + 1, dtype=torch.int64, device=dev)

    (city, nation, region, nat) = _geography(d, n_cust)
    customer = (Table("customer", n_cust)
                .add("c_custkey", "int64", keys(n_cust))
                .add("c_name", "utf8", torch.arange(
                    n_cust, dtype=torch.int32, device=dev),
                    numbered("Customer#", np.arange(1, n_cust + 1), 9))
                .add("c_address", "utf8", *_unique_strings(numbered(
                    "A", d.ints(0, 10**9, n_cust).cpu().numpy(), 9), dev))
                .add("c_city", "utf8", *city)
                .add("c_nation", "utf8", *nation)
                .add("c_region", "utf8", *region)
                .add("c_phone", "utf8", *_unique_strings(_phones(nat, d),
                                                         dev))
                .add("c_mktsegment", "utf8", *d.pick(SEGMENTS, n_cust)))
    (city, nation, region, nat) = _geography(d, n_supp)
    supplier = (Table("supplier", n_supp)
                .add("s_suppkey", "int64", keys(n_supp))
                .add("s_name", "utf8", torch.arange(
                    n_supp, dtype=torch.int32, device=dev),
                    numbered("Supplier#", np.arange(1, n_supp + 1), 9))
                .add("s_address", "utf8", *_unique_strings(numbered(
                    "A", d.ints(0, 10**9, n_supp).cpu().numpy(), 9), dev))
                .add("s_city", "utf8", *city)
                .add("s_nation", "utf8", *nation)
                .add("s_region", "utf8", *region)
                .add("s_phone", "utf8", *_unique_strings(_phones(nat, d),
                                                         dev)))
    mfgr = d.ints(1, 6, n_part)
    category = mfgr * 10 + d.ints(1, 6, n_part)
    brand = category * 100 + d.ints(1, 41, n_part)
    c1 = d.ints(0, len(COLORS), n_part)
    c2 = d.ints(0, len(COLORS), n_part)
    names = [f"{a} {b}" for a in COLORS for b in COLORS]
    types = [f"{a} {b} {c}" for a in TYPE_1 for b in TYPE_2 for c in TYPE_3]
    conts = [f"{a} {b}" for a in CONT_1 for b in CONT_2]
    brands = [f"MFGR#{c}{b}" for c in range(11, 56) for b in range(1, 41)]
    brand_raw = (brand // 100 - 11) * 40 + brand % 100 - 1
    part = (Table("part", n_part)
            .add("p_partkey", "int64", keys(n_part))
            .add("p_name", "utf8", *d.codes(c1 * len(COLORS) + c2, names))
            .add("p_mfgr", "utf8", *d.codes(
                mfgr - 1, [f"MFGR#{m}" for m in range(1, 6)]))
            .add("p_category", "utf8", *d.codes(
                category - 11, [f"MFGR#{c}" for c in range(11, 56)]))
            .add("p_brand1", "utf8", *d.codes(brand_raw, brands))
            .add("p_color", "utf8", *d.pick(COLORS, n_part))
            .add("p_type", "utf8", *d.pick(types, n_part))
            .add("p_size", "int64", d.ints(1, 51, n_part))
            .add("p_container", "utf8", *d.pick(conts, n_part)))
    date = _date_table(dev)
    # day index -> yyyymmdd, past the table's end for commit dates
    span = [FIRST_DAY + datetime.timedelta(days=i) for i in range(N_DAYS + 91)]
    datekey = torch.tensor([r.year * 10000 + r.month * 100 + r.day
                            for r in span], dtype=torch.int64, device=dev)

    lines = _lines_multiset(n_ord, n_lo, d)
    order = torch.repeat_interleave(
        torch.arange(n_ord, device=dev), lines)        # order index a line
    start = torch.cumsum(lines, 0) - lines
    linenumber = torch.arange(n_lo, device=dev) - start[order] + 1
    o_day = d.ints(0, N_DAYS - 151, n_ord)               # dbgen: END - 151
    o_cust = d.ints(1, n_cust + 1, n_ord)
    o_prio = d.ints(0, len(PRIORITIES), n_ord)
    partkey = d.ints(1, n_part + 1, n_lo)
    quantity = d.ints(1, 51, n_lo)
    discount = d.ints(0, 11, n_lo)
    tax = d.ints(0, 9, n_lo)
    # TPC-H's P_RETAILPRICE (4.2.3), in cents
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    extended = quantity * retail
    del retail
    charge = extended * (100 - discount) * (100 + tax) // 10000
    total = torch.zeros(n_ord, dtype=torch.int64, device=dev)
    total.index_add_(0, order, charge)
    del charge
    day = o_day[order]
    lineorder = (Table("lineorder", n_lo)
                 .add("lo_orderkey", "int64", order + 1)
                 .add("lo_linenumber", "int64", linenumber)
                 .add("lo_custkey", "int64", o_cust[order])
                 .add("lo_partkey", "int64", partkey)
                 .add("lo_suppkey", "int64", d.ints(1, n_supp + 1, n_lo))
                 .add("lo_orderdate", "int64", datekey[day])
                 .add("lo_orderpriority", "utf8",
                      *d.codes(o_prio[order], PRIORITIES))
                 .add("lo_shippriority", "int64", torch.zeros(
                     n_lo, dtype=torch.int64, device=dev))
                 .add("lo_quantity", "int64", quantity)
                 .add("lo_extendedprice", "int64", extended)
                 .add("lo_ordtotalprice", "int64", total[order])
                 .add("lo_discount", "int64", discount)
                 .add("lo_revenue", "int64",
                      extended * (100 - discount) // 100)
                 .add("lo_supplycost", "int64", (6 * (
                     90000 + (partkey // 10) % 20001
                     + 100 * (partkey % 1000))) // 10)
                 .add("lo_tax", "int64", tax)
                 .add("lo_commitdate", "int64",
                      datekey[day + d.ints(30, 91, n_lo)])
                 .add("lo_shipmode", "utf8", *d.pick(SHIPMODES, n_lo)))
    del day, order
    return {t.name: t for t in (customer, supplier, part, date, lineorder)}
