"""The TPC-H queries the port runs: the twelve of `benchmarks/tpch_mini.py`
that hold no subquery, with the same texts. `SHIFTED` holds Q6 and Q14 with
their date literals one year later (a replayed program must read the new
literal, not the one it was first run with)."""

QUERIES = {
    "Q1": (
        "SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
        "SUM(l_extendedprice) AS sum_base, "
        "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc, "
        "AVG(l_quantity) AS avg_qty, AVG(l_discount) AS avg_disc, "
        "COUNT(*) AS n "
        "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
        "GROUP BY l_returnflag, l_linestatus "
        "ORDER BY l_returnflag, l_linestatus"
    ),
    "Q3": (
        "SELECT l.l_orderkey, "
        "SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue, "
        "o.o_orderdate, o.o_shippriority "
        "FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem l ON l.l_orderkey = o.o_orderkey "
        "WHERE c.c_mktsegment = 'BUILDING' "
        "AND o.o_orderdate < '1995-03-15' AND l.l_shipdate > '1995-03-15' "
        "GROUP BY l.l_orderkey, o.o_orderdate, o.o_shippriority "
        "ORDER BY revenue DESC LIMIT 10"
    ),
    "Q5": (
        "SELECT n.n_name, "
        "SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue "
        "FROM customer c "
        "JOIN orders o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem l ON l.l_orderkey = o.o_orderkey "
        "JOIN supplier s ON l.l_suppkey = s.s_suppkey "
        "JOIN nation n ON s.s_nationkey = n.n_nationkey "
        "JOIN region r ON n.n_regionkey = r.r_regionkey "
        "WHERE c.c_nationkey = s.s_nationkey AND r.r_name = 'ASIA' "
        "AND o.o_orderdate >= '1994-01-01' AND o.o_orderdate < '1995-01-01' "
        "GROUP BY n.n_name ORDER BY revenue DESC"
    ),
    "Q6": (
        "SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
        "WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01' "
        "AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"
    ),
    "Q7": (
        "SELECT supp_nation, cust_nation, l_year, SUM(volume) AS revenue "
        "FROM (SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation, "
        "EXTRACT(year FROM l.l_shipdate) AS l_year, "
        "l.l_extendedprice * (1 - l.l_discount) AS volume "
        "FROM supplier s JOIN lineitem l ON s.s_suppkey = l.l_suppkey "
        "JOIN orders o ON o.o_orderkey = l.l_orderkey "
        "JOIN customer c ON c.c_custkey = o.o_custkey "
        "JOIN nation n1 ON s.s_nationkey = n1.n_nationkey "
        "JOIN nation n2 ON c.c_nationkey = n2.n_nationkey "
        "WHERE ((n1.n_name = 'NATION01' AND n2.n_name = 'NATION02') "
        "OR (n1.n_name = 'NATION02' AND n2.n_name = 'NATION01')) "
        "AND l.l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'"
        ") shipping "
        "GROUP BY supp_nation, cust_nation, l_year "
        "ORDER BY supp_nation, cust_nation, l_year"
    ),
    "Q8": (
        "SELECT o_year, SUM(CASE WHEN nation = 'NATION05' THEN volume "
        "ELSE 0 END) / SUM(volume) AS mkt_share "
        "FROM (SELECT EXTRACT(year FROM o.o_orderdate) AS o_year, "
        "l.l_extendedprice * (1 - l.l_discount) AS volume, "
        "n2.n_name AS nation "
        "FROM part p JOIN lineitem l ON p.p_partkey = l.l_partkey "
        "JOIN supplier s ON s.s_suppkey = l.l_suppkey "
        "JOIN orders o ON o.o_orderkey = l.l_orderkey "
        "JOIN customer c ON c.c_custkey = o.o_custkey "
        "JOIN nation n1 ON n1.n_nationkey = c.c_nationkey "
        "JOIN region r ON r.r_regionkey = n1.n_regionkey "
        "JOIN nation n2 ON n2.n_nationkey = s.s_nationkey "
        "WHERE r.r_name = 'AMERICA' "
        "AND o.o_orderdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31' "
        "AND p.p_type = 'ECONOMY ANODIZED STEEL') all_nations "
        "GROUP BY o_year ORDER BY o_year"
    ),
    "Q9": (
        "SELECT nation, o_year, SUM(amount) AS sum_profit "
        "FROM (SELECT n.n_name AS nation, "
        "EXTRACT(year FROM o.o_orderdate) AS o_year, "
        "l.l_extendedprice * (1 - l.l_discount) "
        "- ps.ps_supplycost * l.l_quantity AS amount "
        "FROM part p JOIN lineitem l ON p.p_partkey = l.l_partkey "
        "JOIN supplier s ON s.s_suppkey = l.l_suppkey "
        "JOIN partsupp ps ON ps.ps_suppkey = l.l_suppkey "
        "AND ps.ps_partkey = l.l_partkey "
        "JOIN orders o ON o.o_orderkey = l.l_orderkey "
        "JOIN nation n ON s.s_nationkey = n.n_nationkey "
        "WHERE p.p_name LIKE '%green%') profit "
        "GROUP BY nation, o_year ORDER BY nation, o_year DESC"
    ),
    "Q10": (
        "SELECT c.c_custkey, c.c_name, "
        "SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue, "
        "c.c_acctbal, n.n_name "
        "FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem l ON l.l_orderkey = o.o_orderkey "
        "JOIN nation n ON c.c_nationkey = n.n_nationkey "
        "WHERE o.o_orderdate >= '1993-10-01' AND o.o_orderdate < '1994-01-01' "
        "AND l.l_returnflag = 'R' "
        "GROUP BY c.c_custkey, c.c_name, c.c_acctbal, n.n_name "
        "ORDER BY revenue DESC LIMIT 20"
    ),
    "Q12": (
        "SELECT l.l_shipmode, "
        "SUM(CASE WHEN o.o_orderpriority IN ('1-URGENT', '2-HIGH') "
        "THEN 1 ELSE 0 END) AS high_line_count, "
        "SUM(CASE WHEN o.o_orderpriority NOT IN ('1-URGENT', '2-HIGH') "
        "THEN 1 ELSE 0 END) AS low_line_count "
        "FROM orders o JOIN lineitem l ON o.o_orderkey = l.l_orderkey "
        "WHERE l.l_shipmode IN ('MAIL', 'SHIP') "
        "AND l.l_commitdate < l.l_receiptdate "
        "AND l.l_shipdate < l.l_commitdate "
        "AND l.l_receiptdate >= '1994-01-01' "
        "AND l.l_receiptdate < '1995-01-01' "
        "GROUP BY l.l_shipmode ORDER BY l.l_shipmode"
    ),
    "Q13": (
        "SELECT c_count, COUNT(*) AS custdist FROM ("
        "SELECT c.c_custkey, COUNT(o.o_orderkey) AS c_count FROM customer c "
        "LEFT JOIN orders o ON c.c_custkey = o.o_custkey "
        "AND o.o_comment NOT LIKE '%special%requests%' "
        "GROUP BY c.c_custkey) c_orders "
        "GROUP BY c_count ORDER BY custdist DESC, c_count DESC"
    ),
    "Q14": (
        "SELECT 100.00 * SUM(CASE WHEN p.p_type LIKE 'PROMO%' "
        "THEN l.l_extendedprice * (1 - l.l_discount) ELSE 0 END) / "
        "SUM(l.l_extendedprice * (1 - l.l_discount)) AS promo_revenue "
        "FROM lineitem l JOIN part p ON l.l_partkey = p.p_partkey "
        "WHERE l.l_shipdate >= '1995-09-01' AND l.l_shipdate < '1995-10-01'"
    ),
    "Q19": (
        "SELECT SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue "
        "FROM lineitem l JOIN part p ON p.p_partkey = l.l_partkey "
        "WHERE (p.p_brand = 'Brand#12' "
        "AND p.p_container IN ('SM CASE', 'SM BOX') "
        "AND l.l_quantity BETWEEN 1 AND 11 AND p.p_size BETWEEN 1 AND 5 "
        "AND l.l_shipmode IN ('AIR', 'REG AIR')) "
        "OR (p.p_brand = 'Brand#23' "
        "AND p.p_container IN ('MED BAG', 'MED BOX') "
        "AND l.l_quantity BETWEEN 10 AND 20 AND p.p_size BETWEEN 1 AND 10 "
        "AND l.l_shipmode IN ('AIR', 'REG AIR')) "
        "OR (p.p_brand = 'Brand#34' "
        "AND p.p_container IN ('LG CASE', 'LG BOX') "
        "AND l.l_quantity BETWEEN 20 AND 30 AND p.p_size BETWEEN 1 AND 15 "
        "AND l.l_shipmode IN ('AIR', 'REG AIR'))"
    ),
}

# Q6 and Q14 with every date literal one year later
SHIFTED = {
    "Q6": QUERIES["Q6"].replace(
        "l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'",
        "l_shipdate >= '1995-01-01' AND l_shipdate < '1996-01-01'"),
    "Q14": QUERIES["Q14"].replace("'1995-09-01'", "'1996-09-01'")
                         .replace("'1995-10-01'", "'1996-10-01'"),
}
assert all(SHIFTED[q] != QUERIES[q] for q in SHIFTED)
