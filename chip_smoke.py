#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`query_engine_tpu_torch`) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phase 0  prints the card's name and power limit and builds the CUDA kernels
         from `query_engine_tpu_torch/csrc` with nvcc (sm_90a).
Phase 1  holds the grouped SUM/COUNT kernel against its plain PyTorch
         version (`accumulate_plain`) on the same CUDA tensors, bit for bit:
         the main path's shape (2^23 rows, 2048 slots, one int64 item and
         COUNT(*)), Q1's (2^23 rows, 4 of 128 slots, one int64 and three
         float64 items and COUNT(*)), the segment route at 2^23 slots with
         sorted runs of ids (Q3) and with 175 live groups (Q9), 32768
         groups (int64 and float64), int64 values near +-2^62 (wrap-around)
         and float64 with +inf, -inf and NaN. Two kernel runs must give
         identical bits, and float sums must agree with float64 summation
         within the tolerance below. Per case: the kernel's time, its bound
         (bytes over the card's memory rate) and share of it, the entry
         point's, the plain version's and one `index_add_`'s time.
Phase 2  runs the engine's eager path (the compiled pipeline off for this
         Session) through `Session(device="cuda").sql` at 2^23 - 17 fact
         rows and 1024 dimension rows (Query A, the bench query), checks
         that it launched the kernel, and compares the 10 rows exactly with
         an independent numpy oracle. Prints ms per query, rows/s, the
         number of host syncs per query, and one profiled query's device
         time by operator (torch.profiler).
Phase 3  holds the small-table gather kernel, through both entry points
         (int32 indices and a [T, W] int32 table; the join's int64 indices
         and [W, T] int64 planes), against its plain versions at 2^23 rows,
         tables of 1024 and 4096 rows and 1 and 3 words, indices of -1 and
         out of range included: bit-exact. Times the kernel, the plain
         version and `torch.index_select` on indices already in range, and
         prints the bound (each form's own bytes).
Phase 4  runs Query A through the compiled pipeline (the default): the
         first query runs the program and captures it into a CUDA graph,
         later ones replay it. Rows equal the oracle exactly, one host read
         per warm query, and the group_agg kernel appears among the CUDA
         kernels of one profiled replayed query. Then the fact table is
         registered anew from seed 8 at the same capacity: the rows must be
         the new oracle's.
Phase 5  runs Query B (the dimension gains a float64 column `rate`, so the
         join gathers through the packed lookup route) in two Sessions,
         QE_MXU_GATHER unset and then set: rows equal its oracle exactly in
         both, and with the gate set the small gather kernel launches once
         per run of the program (the join's one packed gather) and appears
         among the CUDA kernels of a profiled replayed query. Prints the
         join's device ms with the gate unset and set.

Phase 6  drives the aggregate probes' entry points (`probes.probe_agg_variants
         .run_variant` v1, v2, v4, v5 and `probes.probe_int8_mxu
         .grouped_sum_count_s8`), which run the five one-hot tensor-core
         kernels (all on wgmma), at 2^24 rows and 1024 groups on three data sets: the
         probe's (seed 3), all groups and lanes over the whole int64 range,
         and a sparse wrap-around case (1 % of rows in 7 groups, values near
         +-2^63). Sums and counts must equal the numpy oracle and
         v0_production (the group_agg kernel), with the same bits on a second
         run; each kernel's [G, L] chunk totals must equal its plain
         version's bit for bit. On the probe's data it times each kernel,
         its plain version, its entry point, v0 and one `index_add_` of the
         same sums and counts (CUDA events) and prints rows/s, the
         tensor-core TFLOP/s, the input GB/s, the bound (bytes) and the
         design floor (the dense one-hot product's operations over the
         published int8 or bf16 peak, at the N the kernel issues and at the
         lanes the function needs), each with the kernel's share of it.
Phase 7  builds the TPC-H tables at scale factor 1 (6,001,215 lineitem
         rows; tpch/data.py) on the card and runs all 22 queries through
         Session(device="cuda").sql: the twelve subquery-free ones and the
         ten with scalar, IN, EXISTS and correlated subqueries, a shared
         WITH query (Q15) and COUNT(DISTINCT) (Q16). Each query's rows must
         equal the numpy oracle (tpch/oracle.py) on its first run and on 5
         warm runs: integers, strings and dates exactly, floats to rtol
         1e-9, in ORDER BY order (rows whose float sort keys agree within
         that may swap). Prints per query the median of the warm runs, the
         host syncs, the change in pipeline.stats (with the captures per
         warm query and the host ms in eager leaves and captures), the
         eager leaves and the group_agg launches of its first run. Each
         group_agg call of a first run outside a graph capture (the bounded
         GROUP BY's and the segment route's) is held against the plain
         versions on the same tensors: bit for bit against the kernel's,
         phase 1's tolerance against float64 summation. Fails unless
         group_agg launched in each query of TPCH_GROUP_AGG and its kernel
         appears in each one's profiled warm run, if any query's profiled
         warm run shows torch's `index_add_` kernels, if a query other than
         Q11 returns no rows (tpch_mini's Q11 keeps parts above 1 % of the
         nation's stock, which none reaches at SF1), or if Q6 did not run in
         the compiled pipeline. Then Q11 with TPC-H's FRACTION for SF1
         (0.0001) must give its oracle's rows, some, and Q6 and Q14 with
         their dates a year later on the same Session the shifted oracle's.
         Prints how close a row came to its threshold in Q11, Q17, Q20 and
         Q22 (each compares a row with an aggregate, which the card sums in
         fixed point and the oracle in float64).
Phase 8  runs the window, DISTINCT, set-operation and CROSS join queries of
         `tpch/windows.py` (W1-W6, D1, S1-S3, X1) on phase 7's SF1 tables
         and Session: each one first and 5 times warm, compiled, and once
         with the compiled pipeline off (what QE_COMPILED=0 sets), every
         run against its numpy oracle (floats within rtol 1e-9, plus, in
         a column a float window SUM reaches, 8 * 2^-53 * sum(|x|) of the
         summed plane times the share of that error the column carries: a
         float window SUM is a prefix difference). Prints the warm median ms/query, host syncs, the
         pipeline.stats change, the eager leaves, the largest error against
         its allowance, and one profiled warm run's kernel time by
         operator. Fails if a Window, Distinct or SetOp node runs as an
         eager leaf of a compiled run (except the string set operations of
         STRING_SETOPS: their dictionaries merge on the host), if a float
         window sum differs in its bits between two warm runs, or unless
         group_agg launched in W3 and W5 with no `index_add_` call.
Phase 9  runs the statistics, GROUPING(), scalar-function, regex and
         INTERVAL queries of `tpch/scalar.py` (F1-F6: STDDEV/VAR/CORR/REGR
         over lineitem, DATE_TRUNC/ROUND/ABS/% over orders, a CUBE with
         GROUPING(), UPPER(SPLIT_PART())/LENGTH/`~` over part, the numeric
         functions over customer, and Q1 with its date bound written as an
         INTERVAL) on phase 7's SF1 tables and Session, as phase 8 does:
         first, 5 warm and one eager run each, every one equal to its numpy
         oracle (floats to rtol 1e-9). Prints per query the rows, the warm
         median, host syncs, stats, eager leaves, group_agg launches, each
         float column's largest relative error, F1's cancellation factors,
         and one profiled warm run's kernel ms by operator; each group_agg
         call of a first run is held against the plain versions. Fails
         unless group_agg launched in F1, F2, F3, F5 and F6 and shows in
         their profiled warm runs, if `index_add_` runs, if F1-F3, F5 or F6
         runs an eager leaf or captures again on a warm run, or if F4 runs
         an eager leaf outside STRING_FN_LEAVES.
Phase 10 runs the ordered-set, STRING_AGG, ARRAY_AGG/UNNEST, LIST-function
         and WITH RECURSIVE statements of `tpch/ordered.py` (O1: MEDIAN,
         PERCENTILE_CONT(0.9) and PERCENTILE_DISC(0.5) DESC with COUNT(*)
         and SUM per Q1 group; O2: MODE() ASC and DESC per l_shipmode; O3: a
         median in HAVING and ORDER BY over orders; O4a/O4b: STRING_AGG
         with ORDER BY and DISTINCT over nation/region and part; O5a/O5b:
         ARRAY_AGG exploded by UNNEST, and the words of p_name through
         UNNEST(STRING_TO_ARRAY()) with ARRAY_LENGTH; O6: a 50-round WITH
         RECURSIVE joined to lineitem) on phase 7's SF1 tables and Session:
         first, 5 warm and one eager run each, every one equal to the
         statement's numpy oracle (quantiles by np.sort with PG's index
         rules, MODE by np.unique with PG's tie rule, strings by Python
         joins; floats to rtol 1e-9). Prints per statement the rows, the
         warm median, host syncs, stats (captures per warm query), eager
         leaves, the host ms of the host finalization (STRING_AGG,
         ARRAY_AGG, UNNEST, the recursion's dedup), group_agg launches and
         one profiled warm run's kernel ms by plan node; for O6 the rounds,
         the captures and the pipeline cache entries the recursion left
         and the device memory before and after. Each group_agg call of a
         first run is held against the plain versions. Fails unless
         group_agg launched in O1, O3 and O6, if O6 did not run 50 rounds,
         or if `index_add_` runs in any run of the phase.
Phase 11 runs the Session surface at SF1 on a Session of its own over
         phase 7's host tables, after the earlier phases' Sessions are freed:
         TPC-H's refresh functions (RF1, RF2; TPC-H v3.0.1 §2.5) and the
         statements of `tpch/refresh.py` in order: M1 CREATE INDEX on
         orders; M2 an equality and a range lookup with parameters, whose
         lowered plans hold a PIndexScan that the executor runs; M3 Q6 with
         parameters; M4 RF1 (1,500 orders: 10 by INSERT ... VALUES ...
         RETURNING, the rest and their lineitems by INSERT ... SELECT from
         staging tables); M5 Q1, Q3, Q18; M6 RF2 (DELETE ... WHERE key IN
         (1,500 keys)) and M2 again; M7 Q1, Q3, Q18; M8 an UPDATE of
         customer, then Q10; M9 INSERT ... ON CONFLICT DO UPDATE (50
         existing keys, 50 new); M10 BEGIN, a second RF1, SAVEPOINT, a
         second RF2, ROLLBACK TO, Q1, ROLLBACK, Q1; M11 Q15's view form
         through sql_script; M12 CREATE TABLE AS, ALTER TABLE ADD and
         RENAME COLUMN, DROP TABLE, TRUNCATE; M13 a Session with the result
         cache: Q1, Q1 again (a hit: no program, no group_agg launch, no
         host sync), a DELETE, Q1 (a miss); M14 three rounds of RF1, RF2
         and Q1 with the device memory allocated after each, then two
         rounds with the pipeline's dropping of a replaced table's programs
         turned off, to show what it keeps. Every statement's status or
         rows must equal the numpy oracle's on the edited tables (floats to
         rtol 1e-9). Prints per statement the first (and for a query the
         warm) ms, host syncs and group_agg launches, each index build's
         ms, and the memory before and after. Fails unless group_agg
         launched in M5 and M7, if `index_add_` runs, or if allocated
         memory grows from round 2 to round 3 of M14 by more than
         M14_SLACK.
Phase 12 runs the host services over the card on a Session of its own
         over phase 7's host tables, after phase 11's is freed. 12a: a pgwire
         server (`pgwire/server.py`) in a thread on 127.0.0.1, and 4 client
         connections (`tests/torch_pg_wire.py`, over
         `tests/pg_client.PgTestClient`) that each send the 22 TPC-H queries
         by the simple protocol, connection i from query 5i mod 22 on: every
         DataRow decoded by its type OID and held against the numpy oracle,
         every RowDescription against the schema; each query alone 3 times
         more, and in process through Session.sql. Then Q6 with $1-$3
         parsed once, described, bound and executed with 5 sets of literals;
         RF1 loaded by COPY orders / lineitem FROM STDIN, RF2 by DELETE ...
         IN, then Q1, Q3 and Q18 on the edited tables; COPY nation and
         supplier TO STDOUT against the host tables; BEGIN, DELETE, a bad
         statement and ROLLBACK (ReadyForQuery T, T, T, E, I); SHOW TABLES,
         DESCRIBE, information_schema, DECLARE and FETCH 25 over Q18; Q6
         over a SCRAM-SHA-256 listener. Prints per query the wire ms (first,
         warm with 4 connections, warm alone), Session.sql's warm ms, the
         server's ms and its encoding's host ms, and group_agg's launches.
         12b: lineitem streamed from a MemoryStreamSource in 92 batches of
         2^16 rows into StreamingQuery(device="cuda") with the device
         buffer; a clock that counts batches closes a tumbling window every
         8 (12 windows, the last of 4), each window's Q1 against the oracle
         over exactly its rows, upload_rows against its rows; then all 92
         batches in one window (the table grows to 2^23 rows) against phase
         7's Q1 oracle. 12c: `cli.main` query and bench over
         GENERATE_SERIES(1, 2^23) (printed rows against numpy) and a Repl
         over 12a's Session (.tables, .timing, Q1 parsed back). 12d: Flight
         do_get Q1 and Q3 and a do_put table where pyarrow exists; else it
         prints that Flight did not run. group_agg must launch in 12a (in
         every query of TPCH_GROUP_AGG), 12b and 12c, every first-run call
         held against the plain versions; no `index_add_` on the card.
Phase 13 runs the chunked aggregate and the host stage walk. 13a: a fact
         table of 2^28 - 17 rows (int64 age, salary NULL on about 1 % of
         rows, dept; seed 23; validity arange(cap) < n) and Query A's
         dimension; Query A and Query C (COUNT, AVG, MIN, MAX and a float
         SUM of salary * rate per dept) each a first and 5 warm runs,
         chunked at the defaults (8 chunks of 2^25 rows), then Query A
         unchunked (QE_CHUNK_ENGAGE above the capacity), every run against
         a numpy oracle (integers exactly, floats to rtol 1e-9). Fails
         unless every chunked run makes 8 chunks and every warm one makes
         no new capture of the partial program and 8 replays, or if
         `index_add_` runs, or no group_agg kernel shows in a profiled
         warm chunked Query A. Prints each form's ms (first, warm median,
         min, max), its peak allocated and reserved device memory from a
         reset just before it, its group_agg launches, and the staging
         copy of one chunk's device ms against its bound. Only an out of
         memory error of the unchunked run is recorded as its result
         instead of failing. Apart from those measured runs, each form's
         first run on a Session of its own holds every group_agg call
         outside a capture against the plain versions, and must hold one
         at the chunk's 2^25 rows (the partial program) or, unchunked, at
         2^28. 13b: Q1, Q3, Q5, Q6, Q10, Q12 and Q14 at SF1
         (phase 7's host tables) through `Coordinator(device="cuda")`
         with 4 workers and a DistributedExecutor of 4 partitions, a first
         and 2 warm runs each against the numpy oracle; fails if a query
         is planned local, runs one stage, or shuffles no rows (Q6 aside:
         a global aggregate over one table). Prints ms, stages, rows
         shuffled, the first run's captures, group_agg launches and the
         last run's host ms by stage. 13c: Q1 and Q6 through
         `FlightTransport.execute_on_all` to two Flight servers, each over
         a card Session of its own, both results against the oracle
         (skipped where pyarrow is missing, as 12d). group_agg must launch
         in every form of 13a, every query of 13b and 13c, every call of
         13b's and 13c's first runs (the partial and final aggregates of
         every partition) held against the plain versions; no
         `index_add_` on the card.
Phase 14 runs the mesh building blocks (`parallel/mesh.py`, `spmd.py`,
         `overlap.py`, `dict_merge.py`) on a virtual mesh of 4 shards on
         the card (`make_mesh(["cuda:0"] * 4)`, one host thread a shard),
         over phase 7's host tables: lineitem's 6,001,215 rows in shards of
         2^21, filled front to back, and orders'. (a) The distributed
         aggregate by l_orderkey (COUNT(*), SUM(l_quantity),
         AVG(l_extendedprice), MIN and MAX(l_shipdate), about 1.5M groups,
         no group capacity); (b) the same by (l_returnflag, l_linestatus)
         with a group capacity of 128; (c) join counts of lineitem and
         orders on the order key, salt 1 and 2; (d) the sampled range sort
         by l_extendedprice carrying l_orderkey; (e) the overlapped
         (4 chunks) and the sequential exchange-aggregate of l_quantity by
         l_orderkey; (f) ingest_sharded_strings of l_shipmode in 4 shards;
         (g) join counts on a key that 1/7 of the rows share: the overflow
         output must trip at the default bound, and the caller's
         grow-and-retry (factor doubled) must give the exact join size.
         (c), (d) retry the same way when they overflow, and count it.
         Each result against a numpy oracle: every group on one shard and
         equal to the oracle's (AVG to rtol 1e-9), the join size, each
         shard sorted and below the next, the keys equal to np.sort, the
         bucket sums (numpy's splitmix64 owner), the global sorted codes.
         Per part (a)-(f): the first run's ms, the median and min-max of 5
         warm runs (host clock), one profiled warm run's kernel ms and
         group_agg launches, rows and bytes exchanged, retries. Every
         group_agg call of a first run is held against the plain versions;
         (a), (b) and (e) must launch group_agg; no `index_add_` on the
         card.
Phase 15 runs the joins and aggregates the compiled pipeline sizes at run
         time (`tpch/count_emit.py`) at SF1 on a Session of its own over
         phase 7's host tables: J1 lineitem JOIN partsupp on the part key
         (partsupp's side has multiplicity 2: a static emit at lineitem's
         capacity x 2); J2 the same tables on the supplier key (no bounded
         side: a count program on direct ranks, then the emit program);
         J3 J2 on two key pairs (the count program's joint sort, which the
         emit program reuses); J4a TPC-H Q13's shape with a numeric
         residual (o_totalprice > 100000) in the program; J4b and J4c a
         RIGHT and a FULL join of filtered sides with unmatched rows on
         both; G1a and G1b GROUP BY a computed key and a float key (the
         groups counted first, the aggregate at padded(ng) slots); Q3 and
         Q10 with the GROUP BY keys that a unique-side join makes
         dependent pruned. Each query's rows must equal its numpy oracle
         on its first run and on COUNT_EMIT_WARM warm runs (integers
         exactly, floats to rtol 1e-9). Prints per query the rows and the
         largest relative error, the first run's ms and the warm median
         and min-max, host syncs, the pipeline.stats of the first run and
         per warm run, the eager leaves, group_agg's launches and slots,
         every first-run group_agg call held against the plain versions,
         and one profiled warm run's kernel ms. Fails if a join of J1-J4
         runs as an eager leaf, J2, J3, J4b, J4c, G1a or G1b was not
         sized by a count program, J3's emit did not reuse the count's
         sort, G1's did not aggregate through group_agg at padded(ng)
         slots with the count's grouping, J1 was counted, a warm run of a
         query with no eager leaf compiled or captured anew, Q3's two
         dependent keys were not pruned, or `index_add_` ran on the card.
Phase 16 runs the mesh pipeline (`parallel/mesh_pipeline.py`) at SF1 on 4
         virtual shards of the card (`make_mesh(["cuda:0"] * 4)`, one
         host thread a shard) over phase 7's host tables. 16a: the 22
         TPC-H queries through `Session(device="cuda", mesh=...)`, each
         first (every group_agg call outside a capture held against the
         plain versions), MESH_TPCH_WARM times warm and once profiled, its
         rows against the numpy oracle (floats to rtol 1e-9); per query it
         prints whether it lowered to the mesh or fell back, the change in
         `mesh_pipeline.stats`, the rows (`Mesh.rows_exchanged()`) and
         bytes exchanged, first and warm ms, and the profiled run's kernel
         ms and group_agg launches, beside the card's name and power limit.
         16b: phase 15's J2 (no bounded side) through the mesh, which must
         size it by a count program (`joins_counted`). 16c: Q1, Q6 and Q14
         over pgwire from one client to a Session that `QE_MESH_DEVICES=4`
         makes (4 virtual shards of the card), and Q1 and Q6 through
         `DistributedExecutor(mesh=...)`, which must not take the stage
         walk. Fails on any row that differs from its oracle, unless Q1
         lowered and launched group_agg, or if `index_add_` ran on the
         card.
Phase 17 runs the open-addressing hash join (`ops/hash_join.py`, kernels
         in `csrc/hash_join.cu`), which no engine route reaches (phases 1-16
         must launch neither kernel), through its entry point
         `hash_join_unique` with the counts at 0: (a) docs/TPU_DESIGN.md
         #10's shape, 2^20 build rows (2^20 - 3 live) of unique int64 keys
         from [0, 2^48) and 2^23 probe rows (2^23 - 17 live, ~2 % not ok,
         10 % of keys absent from the build), T = table_size_for(2^20);
         (b) bench.py's (`_build_args`): 2^24 - 17 int32 probe keys from
         U[0, 2^20) (2 % NULL), the build a permutation of [0, 2^20) with 3
         pad rows; (c) long chains: 100 keys 4096 apart at T = 128, and
         load 0.9 at T = 2^16. Each case's (ri, matched) must equal a numpy
         oracle (np.searchsorted over the live build keys) and the plain
         versions run on the card, the build kernel's table must pass
         `check_table` (the plain build's entries, each on its own probe
         sequence with no empty slot before it), and the probe kernel must
         give the plain results on its own table and on the plain one. (d)
         200 live rows into 128 slots must raise ValueError from
         `hash_build` and `hash_join_unique`. At (a) and (b) it times (median
         of CUDA graph replays, each between CUDA events) the build (one
         call: the packed table's fill and the claims), the probe and the two
         together, and prints each beside its bound (each input read and
         each output written once, the table once at key bytes + 4 a slot,
         over 3.35 TB/s), the plain versions' (eager, median of 3), the
         sort-rank route's (`K.join_ranks` then `K.fk_join_right_lookup`)
         and the library route's (torch.sort of the build,
         torch.searchsorted and gathers), each route checked against the
         oracle first. It prints ptxas's registers and spills for the six
         hash kernels (the build's fill and claim kernels and the probe,
         int32 and int64 keys) and, where the toolkit has cuobjdump, their
         global loads, stores and atomics in SASS; it fails unless each
         probe loads the packed slot with one vector load (LDG ... .128 for
         int64 keys, .64 for int32), each build claims with a CAS (64-bit
         for int32 keys) and each fill writes a slot with one store.
Phase 18 runs TPC-H at scale factor 10 (59,986,052 lineitem rows, capacity
         2^26; orders 14,996,513 at 2^24; tpch/data.py) on one
         Session(device="cuda") of its own, after the earlier phases'
         Sessions are freed: the 22 queries (Q11 with TPC-H's FRACTION for
         SF10, 0.00001) and tpch/scalar.py's F1 and F6, each first (every
         group_agg call of the first run outside a capture held against
         the plain versions), then SF10_WARM times warm, every run against
         its numpy oracle at rtol 1e-9. Prints the tables' generation and
         registration seconds and device memory; per statement the warm
         median ms, host syncs, captures per warm query, the first run's
         stats (joins demoted and counted), group_agg launches, the largest
         relative error, the allocated and reserved memory after it and
         the cached programs, the out-of-memory reruns and graphs
         released on the first and per warm run, and a census of what
         holds the allocated memory (`memory_census`: the tables, the
         live graphs' outputs and inputs, other fields of the cached
         programs, the rest of the Session, other CUDA tensors, no
         tensor); Q9's and F1's error by float column; Q1, Q6
         and Q9 profiled once for their kernel ms; the rows' margins to
         their thresholds; the peak allocated and reserved memory. Fails
         on any row that differs from its oracle, unless group_agg
         launched (and was held) in each query of TPCH_GROUP_AGG and in F1
         and F6, if `index_add_` ran on the card, or if a first or warm
         run ran out of memory and was run again. Its Session and tables
         stay for phase 19.
Phase 19 runs phases 8-10's and 15's statements at SF10 on phase 18's
         Session and tables, after its 24 statements: tpch/windows.py's
         W1-W6, D1, S1-S3 and X1, tpch/scalar.py's F2-F5, tpch/ordered.py's
         O1-O6 with O4a/b and O5a/b, and tpch/count_emit.py's J1-J4c, G1a
         and G1b (Q3 and Q10 are phase 18's), texts as at SF1. Each
         statement is held against its numpy oracle (computed once) on its
         first run and SF10_WARM warm runs: the window queries within
         `windows.allowance` plus rtol 1e-9, the rest at rtol 1e-9 with
         integers, strings and dates exact. Per statement it prints the
         rows, first-run ms, warm median ms, host syncs, captures per warm
         query, group_agg launches, oracle seconds, out-of-memory reruns,
         graphs released in first and warm runs, the allocated and reserved
         memory after it and the census; for W2-W5 the largest float error
         against its allowance; W1 and J1 profiled once; the phase's
         seconds and peak memory. Fails as phases 8-10 and 15 do (a
         Window, Distinct or SetOp node as an eager leaf but S3's, a float
         window sum whose bits differ between warm runs, F2-F5's eager
         leaves or warm recaptures, O6 short of 50 rounds, a count→emit
         join demoted, run as an eager leaf, not counted or not reusing
         the count's sort or grouping, a warm recompile, group_agg not
         launched where it launched at SF1, an unheld group_agg call,
         `index_add_` on the card), except that J1, a static emit at SF1,
         must be counted at SF10: lineitem's capacity 2^26 times its
         multiplicity 2 passes the pipeline's _MAX_EMIT, as in the
         reference. Fails on any out-of-memory rerun. Then the Session
         and tables are freed, and the allocated memory must come within
         SF10_FREED_SLACK of phase 18's start.

After each of phases 11-17 a line gives the device memory still allocated
with that phase's Sessions freed, and past 64 MiB the largest CUDA tensors
left and what holds them (`phase_memory`).

Each path runs with the kernels' launch counts set to 0 just before it and
read just after; a kernel of the path that was not launched fails the run.
A replayed CUDA graph runs no Python, so on the compiled paths the counts
move when the program first runs and when it is captured, and the
profiler's kernel names show what a replay ran.

The line before the last is one JSON object with the kernels' launches,
errors, times, bounds and library times; the last line is {"ok": true,
"device": {...}}. Any failed
check exits non-zero without those lines, and so does a machine without
CUDA or a directory without the package.
"""

import collections
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 7
N_FACT = (1 << 23) - 17  # 17 pad rows at capacity 2^23
N_DIM = 1024
QUERY = ("SELECT f.dept, COUNT(*) AS c, SUM(f.salary + d.bonus) AS s "
         "FROM f JOIN d ON f.dept = d.dept_id "
         "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10")
QUERY_B = ("SELECT f.dept, COUNT(*) AS c, SUM(f.salary * d.rate) AS s "
           "FROM f JOIN d ON f.dept = d.dept_id "
           "WHERE f.age > 25 GROUP BY f.dept ORDER BY s DESC LIMIT 10")
# Fixed point against float64 summation: the kernel sums round(x * 2^k)
# exactly and rescales, an error of at most m * max|x| * 2^-62 a group of m
# rows (plus one rounding) against the plain float64 index_add's own
# round-off; the tolerance is the bound of the JAX package's kernel tests
# (tests/test_pallas_kernels.py).
RTOL = 1e-9
ATOL_PER_MAX = 1e-9  # atol = max|x| * 1e-9


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, from CUDA events around `iters`
    back-to-back calls after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Mean device time of fn() in ms: `iters` calls captured into one CUDA
    graph, replayed between CUDA events, so the host's launch overhead (the
    wrapper's Python) is not in it. fn must read nothing back to the
    host."""
    import torch

    fn()
    fn()  # eager warm-up: builds, caches launch attributes, fills pools
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def phase0():
    from query_engine_tpu_torch.ops._build import load_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    built = load_library()
    print(f"phase 0: built {built.path.name} in {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return card


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


def bound_ms(nbytes):
    """The least time the card could take to move `nbytes`: each input read
    once and each output written once at the published memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _items(rng, n, kinds, dev):
    import torch

    items = []
    for kind in kinds:
        ok = torch.from_numpy(rng.random(n) < 0.85).to(dev)
        if kind == "count_star":  # reads only its ok plane
            v = None
        elif kind == "i64":
            v = torch.from_numpy(rng.integers(50_000, 151_000, n)).to(dev)
        elif kind == "i64_wrap":
            v = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)
                                 + np.where(rng.random(n) < 0.5,
                                            (1 << 62) - 1, -(1 << 62))).to(dev)
        elif kind == "f64":
            v = torch.from_numpy(rng.normal(0.0, 1e7, n)).to(dev)
        elif kind == "f64_price":  # TPC-H amounts: positive, below 1e5
            v = torch.from_numpy(rng.random(n) * 1e5).to(dev)
        else:  # f64 with +inf, -inf and NaN rows
            x = rng.normal(0.0, 1e3, n)
            x[rng.random(n) < 1e-4] = np.inf
            x[rng.random(n) < 1e-4] = -np.inf
            x[rng.random(n) < 1e-4] = np.nan
            v = torch.from_numpy(x).to(dev)
        items.append((v, ok))
    return items


def _gids(rng, n, case):
    """Group ids of a phase-1 case: "uniform" over the used slots, "sorted
    runs" in row order (Q3's lineitem rows by l_orderkey), 1 % excluded."""
    kind, used = case
    if kind == "sorted runs":
        g = np.repeat(np.arange(n), rng.integers(1, 8, n))[:n]
    else:
        g = rng.integers(0, used, n)
    g[rng.random(n) < 0.01] = -1  # excluded rows
    return g


def index_add_library(items, gid, G):
    """`library_ms` of a grouped SUM/COUNT: one `index_add_(0, gid64, src)`
    of an int64 source (the sums' columns: an integer item's values, a
    float item's fixed-point q as its low and high 32 bits, a COUNT item's
    ones; then each item's ok as 0/1) into [G + 1, columns], ids outside
    the range on row G. The source is made here, outside the timing;
    returns the function to time."""
    import torch

    from query_engine_tpu_torch.ops import group_agg

    cols = []
    for v, ok in items:
        if v is None:
            v = torch.ones_like(ok, dtype=torch.int64)
        elif v.is_floating_point():
            q, _ = group_agg.quantize(v, ok)
            cols.append(torch.where(ok, q & group_agg.LOW, 0))
            v = q >> group_agg.HALF
        cols.append(torch.where(ok, v.to(torch.int64), 0))
    cols += [ok.to(torch.int64) for _, ok in items]
    src = torch.stack(cols, 1).contiguous()
    g = gid.to(torch.int64)
    g = torch.where((g >= 0) & (g < G), g, G)
    out = torch.zeros((G + 1, src.shape[1]), dtype=torch.int64,
                      device=src.device)
    return lambda: out.index_add_(0, g, src)


def group_agg_bytes(items, gid, G):
    """Bytes the grouped SUM/COUNT must move: gid, each item's values and ok
    plane read once, its output rows ([R, G] int64) written once."""
    from query_engine_tpu_torch.ops import group_agg

    rows = sum(group_agg.ROWS[group_agg._kind(v)] for v, _ in items)
    return (gid.nbytes + sum(ok.nbytes + (0 if v is None else v.nbytes)
                             for v, ok in items) + rows * G * 8)


def phase1():
    """group_agg against its plain version at the main path's shapes; returns
    the largest absolute errors (against the plain version, against float64
    summation) and the numbers of each case."""
    import torch

    from query_engine_tpu_torch.ops import group_agg

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n23 = 1 << 23
    cases = [  # name, n, G, (ids, used slots), gid dtype, item kinds
        ("main path shape", n23, 2048, ("uniform", 1024), torch.int32,
         ["i64", "count_star"]),
        ("Q1 shape", n23, 128, ("uniform", 4), torch.int64,
         ["i64", "f64_price", "f64_price", "f64_price", "count_star"]),
        ("sorted runs, G = 2^23", n23, n23, ("sorted runs", 0), torch.int64,
         ["f64_price"]),
        ("175 live of G = 2^23", n23, n23, ("uniform", 175), torch.int64,
         ["f64_price"]),
        ("32768 groups", n23, 32768, ("uniform", 32768), torch.int32,
         ["i64", "f64"]),
        ("wrap-around", 1 << 20, 2048, ("uniform", 2048), torch.int32,
         ["i64_wrap"]),
        ("inf/-inf/NaN", 1 << 20, 2048, ("uniform", 2048), torch.int32,
         ["f64_ieee", "i64", "count_star"]),
    ]
    max_err = {"plain": 0.0, "float64": 0.0}
    out = {}
    for name, n, G, ids, gdt, kinds in cases:
        gid = torch.from_numpy(_gids(rng, n, ids)).to(dev).to(gdt)
        items = _items(rng, n, kinds, dev)
        rows, inv = group_agg.accumulate_kernel(items, gid, G)
        rows2, inv2 = group_agg.accumulate_kernel(items, gid, G)
        want_rows, want_inv = group_agg.accumulate_plain(items, gid, G)
        torch.cuda.synchronize()
        max_err["plain"] = max(max_err["plain"], float(
            (rows - want_rows).abs().max()), float(
            (inv - want_inv).abs().max()) if inv.numel() else 0.0)
        check(torch.equal(rows, want_rows) and torch.equal(inv, want_inv),
              f"{name}: kernel rows differ from the plain version's")
        check(torch.equal(rows, rows2) and torch.equal(inv, inv2),
              f"{name}: two kernel runs differ")
        got = group_agg.grouped_sums_counts_multi(items, gid, G)
        same = group_agg.fixed_point(items, gid, G, group_agg.accumulate_plain)
        f64 = group_agg.grouped_sums_counts_multi_plain(items, gid, G)
        for kind, (v, _), (s, c), (ps, pc), (ws, wc) in zip(
                kinds, items, got, same, f64):
            check(s.is_cuda and c.is_cuda, f"{name}: result not on the card")
            check(torch.equal(c, pc) and torch.equal(c, wc),
                  f"{name} {kind}: counts differ")
            check(torch.equal(s.view(torch.int64), ps.view(torch.int64)),
                  f"{name} {kind}: sums differ from the plain version's bits")
            if not s.is_floating_point():
                check(torch.equal(s, ws), f"{name} {kind}: int sums differ")
                continue
            a, b = s.cpu().numpy(), ws.cpu().numpy()
            x = v.cpu().numpy()
            atol = float(np.abs(x[np.isfinite(x)]).max()) * ATOL_PER_MAX
            close = np.isclose(a, b, rtol=RTOL, atol=atol, equal_nan=True)
            check(bool(close.all()),
                  f"{name} {kind}: {int((~close).sum())} float sums outside "
                  f"rtol {RTOL} atol {atol} of float64 summation")
            both = np.isfinite(a) & np.isfinite(b)
            if both.any():
                max_err["float64"] = max(max_err["float64"], float(
                    np.abs(a[both] - b[both]).max()))
        k_ms = graph_ms(lambda: group_agg.accumulate_kernel(items, gid, G))
        e_ms = graph_ms(lambda: group_agg.grouped_sums_counts_multi(
            items, gid, G))
        p_ms = graph_ms(lambda: group_agg.accumulate_plain(items, gid, G),
                        iters=3)
        lib_ms = graph_ms(index_add_library(items, gid, G), iters=3)
        nbytes = group_agg_bytes(items, gid, G)
        b_ms = bound_ms(nbytes)
        out[name] = {"ms": k_ms, "entry_ms": e_ms, "plain_ms": p_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bytes": nbytes}
        print(f"phase 1: {name}: n={n} G={G} gid {str(gdt)[6:]} {kinds}: "
              "kernel == plain version bit for bit (rows, scales, sums, "
              "counts), two runs bit-identical, floats within tolerance of "
              f"float64 summation; kernel {k_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({nbytes} bytes, {100 * b_ms / k_ms:.1f} % of it), entry "
              f"point {e_ms:.4f} ms, plain {p_ms:.4f} ms, library "
              f"(index_add_) {lib_ms:.4f} ms (device time: CUDA graph "
              "replays between CUDA events)")
    return max_err, out


def make_tables(dev, seed=SEED):
    """The bench's fact and dimension tables from one seed; Query B's
    dimension adds `rate` = integers(128, 384) / 256, drawn after."""
    from query_engine_tpu_torch.columnar.batch import padded_capacity
    from query_engine_tpu_torch.columnar.convert import from_numpy_batch
    from query_engine_tpu_torch.core.schema import Field
    from query_engine_tpu_torch.core.types import DataType

    rng = np.random.default_rng(seed)
    n, cap = N_FACT, padded_capacity(N_FACT)
    cols = {
        "age": rng.integers(18, 65, n),
        "salary": rng.integers(50_000, 150_000, n),
        "dept": rng.integers(0, N_DIM, n),
    }
    bonus = rng.integers(0, 1000, N_DIM)
    rate = rng.integers(128, 384, N_DIM) / 256
    valid = np.arange(cap) < n
    i64, f64 = DataType.int64(), DataType.float64()

    def planes(arr):
        data = np.zeros(cap, dtype=arr.dtype)
        data[:n] = arr
        return data, valid, None

    fact = from_numpy_batch([Field(k, i64) for k in cols],
                            [planes(v) for v in cols.values()], n, dev)
    dcap = padded_capacity(N_DIM)
    dvalid = np.arange(dcap) < N_DIM

    def dplanes(arr):
        data = np.zeros(dcap, dtype=arr.dtype)
        data[:N_DIM] = arr
        return data, dvalid, None

    dfields = [Field("dept_id", i64), Field("bonus", i64)]
    dcols = [dplanes(np.arange(N_DIM)), dplanes(bonus)]
    dim = from_numpy_batch(dfields, dcols, N_DIM, dev)
    dim_rate = from_numpy_batch(dfields + [Field("rate", f64)],
                                dcols + [dplanes(rate)], N_DIM, dev)
    return cols, bonus, rate, fact, dim, dim_rate


def oracle(cols, per_dept, combine):
    """numpy: mask, join by dept (dept_id = arange, so a lookup), sum per
    dept, then a stable sort on -s over the groups in dept order. Query B's
    products are multiples of 2^-8 below 2^53, so its float64 sums are
    exact in any order."""
    m = cols["age"] > 25
    dept = cols["dept"][m]
    val = combine(cols["salary"][m], per_dept[dept])
    c = np.bincount(dept, minlength=N_DIM)
    s = np.zeros(N_DIM, dtype=val.dtype)
    np.add.at(s, dept, val)
    groups = np.nonzero(c)[0]
    order = groups[np.argsort(-s[groups], kind="stable")][:10]
    return [(int(g), int(c[g]), s[g].item()) for g in order]


def oracle_a(cols, bonus):
    return oracle(cols, bonus, np.add)


def oracle_b(cols, rate):
    return oracle(cols, rate, np.multiply)


def reset_counts():
    from query_engine_tpu_torch.ops import agg_variants, group_agg, small_gather

    group_agg.launches = 0
    small_gather.launches = 0
    for v in agg_variants.launches:
        agg_variants.launches[v] = 0


def read_counts():
    from query_engine_tpu_torch.ops import agg_variants, group_agg, small_gather

    return {"group_agg": group_agg.launches,
            "small_gather": small_gather.launches,
            **{f"onehot_{v}": k for v, k in agg_variants.launches.items()}}


# Profiles taken of one run at most: a profile in which no CUDA kernel shows
# is taken again. CUPTI has dropped every kernel of a profiled run on the
# card (a program body of 0.36 ms of kernels), once in many runs.
PROFILE_TRIES = 3


def profiled(run):
    """`run()` under torch.profiler (CPU and CUDA activity), to the end of a
    synchronize; taken again while the profile shows no CUDA kernel time,
    PROFILE_TRIES times at most. Returns the last profile, the number of
    tries and what the last `run()` returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run()
            torch.cuda.synchronize()
        if any(e.device_type == cuda and e.self_device_time_total > 0
               for e in prof.key_averages()):
            break
    return prof, tries, res


def profile_query(sess, query, tag):
    """One query under torch.profiler: prints the top of its table by CUDA
    time and returns the names of the CUDA kernels it ran."""
    import torch

    prof, _, _ = profiled(lambda: sess.sql(query).to_pylist())
    print(f"{tag}: profiled query, top operators by CUDA time:")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25))
    events = prof.events()
    names = {e.name for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return names | {k.name for e in events for k in getattr(e, "kernels", ())}


def profile_program(sess, tag, entry=None):
    """Device time of a captured program by operator (the session's only
    one unless `entry` is given): its body run once eagerly (the same
    kernels a replay runs) under torch.profiler, where each operator's own
    kernels sit under its pipeline:<operator> range. Returns the total and
    {operator: ms}. Where the profiler saw no kernel in PROFILE_TRIES
    profiles, the body's time between two CUDA events and no operators."""
    import torch

    pipe = sess.executor.pipeline
    if entry is None:
        (entry,) = [e for e in pipe._cache.values() if e.graph is not None]

    def body():
        pipe._body(entry, entry.planes, entry.n_bufs, entry.dyn_bufs,
                   entry.xfer)

    prof, tries, _ = profiled(body)
    # a range appears twice: as a CPU event, whose device time is the sum
    # of the kernels launched inside it, and as a GPU annotation spanning
    # it on the device's timeline (gaps included); kernels are the rest
    events = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    total = sum(e.self_device_time_total for e in events
                if e.device_type == cuda and not e.key.startswith("pipeline:"))
    if not total:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        body()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        check(ms > 0, f"{tag}: no device time between CUDA events")
        print(f"{tag}: the profiler saw no device time in {tries} profiles; "
              f"program body run eagerly: {ms:.3f} ms between two CUDA "
              "events (launch gaps included), no operator breakdown")
        return ms, {}
    if tries > 1:
        print(f"{tag}: the profiler saw device time at try {tries}")
    ops = sorted(((e.key, e.device_time_total) for e in events
                  if e.device_type == cpu and e.key.startswith("pipeline:")),
                 key=lambda kv: -kv[1])
    print(f"{tag}: program body run eagerly: {total / 1e3:.3f} ms of kernel "
          "time; by operator (kernels launched inside its range):")
    for name, us in ops + [("other (leaf masks, result count)",
                            total - sum(us for _, us in ops))]:
        print(f"  {name:<34} {us / 1e3:8.3f} ms  {100 * us / total:5.1f} %")
    for e in events:  # launched through ctypes, outside any aten op
        if e.device_type == cuda and any(
                k in e.key for k in ("sum_count_", "float_absmax",
                                     "gather_words")):
            print(f"  of which hand kernel {e.key[:40]}: "
                  f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} "
                  "launches")
    return total / 1e3, {name: us / 1e3 for name, us in ops}


def kernel_names(names, *parts):
    return sorted(nm for nm in names if any(p in nm for p in parts))


def timed_runs(sess, query, tag, want):
    """Median of 5 warm runs (host clock, result on the host) and the host
    syncs per query; every run's rows must equal `want`."""
    walls = []
    syncs0 = sess.executor.host_syncs
    for _ in range(5):
        t0 = time.perf_counter()
        rows = sess.sql(query).to_pylist()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(rows == want, f"{tag}: a warm run's rows differ")
    syncs = (sess.executor.host_syncs - syncs0) / 5
    ms = statistics.median(walls)
    print(f"{tag}: {ms:.3f} ms/query median of 5 warm runs (host clock, "
          f"result on the host), {N_FACT / ms * 1e3:,.0f} fact rows/s, "
          f"{syncs:g} host syncs/query")
    return ms, syncs


def phase2(tables):
    import torch

    from query_engine_tpu_torch.engine.session import Session

    cols, bonus, _, fact, dim, _ = tables
    sess = Session(device="cuda")
    sess.executor._compiled = False  # the eager path
    sess.register_table("f", fact)
    sess.register_table("d", dim)
    sess.sql(QUERY).to_pylist()  # warm-up
    torch.cuda.synchronize()

    reset_counts()
    syncs0 = sess.executor.host_syncs
    out = sess.sql(QUERY)
    torch.cuda.synchronize()
    launches = read_counts()
    syncs = sess.executor.host_syncs - syncs0
    check(launches["group_agg"] > 0,
          "the eager path did not launch the group_agg kernel")
    for f, col in zip(out.schema, out.columns):
        check(col.data.is_cuda and col.validity.is_cuda,
              f"result column {f.name} is not a CUDA tensor")
    rows = out.to_pylist()
    want = oracle_a(cols, bonus)
    check(rows == want, f"eager path rows differ from the oracle:\n{rows}\n"
                        f"{want}")
    print(f"phase 2: {QUERY}")
    print(f"phase 2: eager Query A: {len(rows)} rows == numpy oracle; first "
          f"{rows[0]}; {syncs} host syncs, launches {launches}")
    ms, _ = timed_runs(sess, QUERY, "phase 2: eager Query A", want)
    profile_query(sess, QUERY, "phase 2: eager Query A")
    return ms


GATHER_N = 1 << 23
# phase 3's shapes (T, W): Query B's table of 1024 rows, 1 word, and the
# engine's largest table, 4096 rows, at 1 and 3 words
GATHER_SHAPES = ((1024, 1), (1024, 3), (4096, 1), (4096, 3))


def gather_inputs(rng, T, W, dev, n=GATHER_N):
    """The small gather's inputs at one shape: int32 indices and the
    [T, W] int32 table (the JAX function's form), the same indices as int64
    and the same words as int64 planes [W, T] (the join's form); 5 % of
    indices -1, 1 % T, two far out of range."""
    import torch

    table = torch.from_numpy(rng.integers(-(2**31), 2**31, (T, W)).astype(
        np.int32)).to(dev)
    idx = rng.integers(0, T, n)
    idx[rng.random(n) < 0.05] = -1  # unmatched rows
    idx[rng.random(n) < 0.01] = T  # just past the table
    idx[:2] = [2**31 - 1, -(2**31)]
    idx64 = torch.from_numpy(idx).to(dev)
    planes = (table.T.to(torch.int64) & 0xFFFFFFFF).contiguous()
    return idx64.to(torch.int32), table, idx64, planes


def gather_forms(T, W, inputs, n=GATHER_N):
    """{form: (kernel, plain, library, bytes)} of the small gather's two
    entry points on `inputs` (gather_inputs): the library call is one
    index_select on indices already in range; bytes are the indices read
    once, the output written once and the table read once."""
    import torch

    from query_engine_tpu_torch.ops import small_gather as sg

    idx32, table, idx64, planes = inputs
    in_range = idx64.clamp(0, T - 1)
    return {
        "u32": (lambda: sg.gather_words(idx32, table),
                lambda: sg.gather_words_plain(idx32, table),
                lambda: torch.index_select(table, 0, in_range),
                n * 4 + n * W * 4 + T * W * 4),
        "planes": (lambda: sg.gather_word_planes(idx64, planes),
                   lambda: sg.gather_word_planes_plain(idx64, planes),
                   lambda: torch.index_select(planes, 1, in_range),
                   n * 8 + n * W * 8 + T * W * 8),
    }


def phase3():
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    max_err = 0
    times = {}
    for T, W in GATHER_SHAPES:
        forms = gather_forms(T, W, gather_inputs(rng, T, W, dev))
        for form, (kernel, plain, library, nbytes) in forms.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            check(got.is_cuda and got.shape == want.shape
                  and got.dtype == want.dtype,
                  f"small gather {form} T={T} W={W}: bad result")
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs()
                      .max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"small gather {form} T={T} W={W}: kernel != plain")
            k_ms = graph_ms(kernel)
            p_ms = graph_ms(plain)
            lib_ms = graph_ms(library)
            times[f"{form} T={T} W={W}"] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms(nbytes), "bytes": nbytes}
            print(f"phase 3: small gather {form} n={GATHER_N} T={T} W={W}: "
                  f"kernel == plain bit for bit; kernel {k_ms:.4f} ms "
                  f"({nbytes / k_ms / 1e6:.1f} GB/s of {nbytes} bytes), "
                  f"bound {bound_ms(nbytes):.4f} ms "
                  f"({100 * bound_ms(nbytes) / k_ms:.1f} % of it), plain "
                  f"{p_ms:.4f} ms, library (index_select) {lib_ms:.4f} ms "
                  "(device time: CUDA graph replays between CUDA events)")
    return max_err, times


def phase4(tables, eager_ms):
    import torch

    from query_engine_tpu_torch.engine.session import Session

    cols, bonus, _, fact, dim, _ = tables
    sess = Session(device="cuda")
    check(sess.executor._compiled, "QE_COMPILED is off in this environment")
    sess.register_table("f", fact)
    sess.register_table("d", dim)
    want = oracle_a(cols, bonus)
    reset_counts()
    t0 = time.perf_counter()
    rows = sess.sql(QUERY).to_pylist()  # runs the program, then captures it
    first_ms = (time.perf_counter() - t0) * 1e3
    check(rows == want, f"compiled Query A rows differ from the oracle:\n"
                        f"{rows}\n{want}")
    rows = sess.sql(QUERY).to_pylist()  # the first replay
    torch.cuda.synchronize()
    launches = read_counts()
    check(rows == want, "compiled Query A: a replay's rows differ")
    check(launches["group_agg"] > 0,
          "the compiled path did not launch the group_agg kernel")
    st = dict(sess.executor.pipeline.stats)
    check(st["compiles"] >= 1 and st["hits"] >= 1 and st["replays"] >= 1
          and st["joins_inlined"] >= 1,
          f"compiled Query A did not compile and replay: {st}")
    print(f"phase 4: compiled Query A: rows == numpy oracle; first query "
          f"(run + capture) {first_ms:.1f} ms; launches {launches}; {st}")
    ms, syncs = timed_runs(sess, QUERY, "phase 4: compiled Query A", want)
    check(syncs == 1, f"compiled Query A: {syncs} host syncs per warm query")
    names = profile_query(sess, QUERY, "phase 4: compiled Query A (replay)")
    profile_program(sess, "phase 4: compiled Query A")
    found = kernel_names(names, "sum_count_shared")
    check(found, "the group_agg kernel is not among a replayed query's CUDA "
                 f"kernels: {sorted(names)}")
    print(f"phase 4: the replayed query ran {found}")
    print(f"phase 4: Query A eager {eager_ms:.3f} ms vs compiled {ms:.3f} "
          f"ms per query ({eager_ms / ms:.2f}x)")

    # the fact table anew at the same capacity: the graph must read it
    cols8, _, _, fact8, _, _ = make_tables(torch.device("cuda"), seed=8)
    captures = sess.executor.pipeline.stats["captures"]
    sess.register_table("f", fact8)
    want8 = oracle_a(cols8, bonus)
    check(want8 != want, "seed 8 gives the same rows as seed 7")
    rows = sess.sql(QUERY).to_pylist()
    check(rows == want8, f"after re-registering f: rows differ from the "
                         f"new oracle:\n{rows}\n{want8}")
    st = sess.executor.pipeline.stats
    check(st["captures"] == captures + 1,
          f"re-registering f did not capture anew: {st}")
    check(sess.sql(QUERY).to_pylist() == want8,
          "a replay after re-registering f differs")
    print("phase 4: f registered anew from seed 8: rows == the new oracle "
          "(captured again over the new planes, then replayed)")
    return launches["group_agg"], found


def phase5(tables):
    import torch

    from query_engine_tpu_torch.engine.session import Session

    cols, _, rate, fact, _, dim_rate = tables
    want = oracle_b(cols, rate)
    out = {}
    for gate in ("unset", "set"):
        if gate == "set":
            os.environ["QE_MXU_GATHER"] = "1"
        else:
            os.environ.pop("QE_MXU_GATHER", None)
        sess = Session(device="cuda")  # reads the gate
        sess.register_table("f", fact)
        sess.register_table("d", dim_rate)
        reset_counts()
        rows = sess.sql(QUERY_B).to_pylist()
        rows2 = sess.sql(QUERY_B).to_pylist()
        torch.cuda.synchronize()
        launches = read_counts()
        check(rows == want and rows2 == want,
              f"Query B (QE_MXU_GATHER {gate}) rows differ from the oracle:"
              f"\n{rows}\n{want}")
        check(launches["group_agg"] > 0,
              f"Query B ({gate}) did not launch the group_agg kernel")
        # set: one launch per run of the program (its first run and its
        # capture), the join's one packed gather
        check(launches["small_gather"] == (2 if gate == "set" else 0),
              f"Query B ({gate}): small gather launches {launches}")
        st = dict(sess.executor.pipeline.stats)
        check(st["replays"] >= 1 and st["joins_inlined"] >= 1,
              f"Query B ({gate}) did not compile and replay: {st}")
        print(f"phase 5: Query B, QE_MXU_GATHER {gate}: rows == numpy "
              f"oracle (exact floats); first {rows[0]}; launches "
              f"{launches}; {st}")
        ms, syncs = timed_runs(sess, QUERY_B, f"phase 5: Query B ({gate})",
                               want)
        check(syncs == 1, f"Query B ({gate}): {syncs} host syncs per query")
        names = profile_query(sess, QUERY_B,
                              f"phase 5: Query B ({gate}, replay)")
        _, ops = profile_program(sess, f"phase 5: Query B ({gate})")
        found = kernel_names(names, "gather_words")
        check(bool(found) == (gate == "set"),
              f"Query B ({gate}): gather kernels in the replay: {found}")
        check(kernel_names(names, "sum_count_"),
              f"Query B ({gate}): no group_agg kernel in the replay")
        out[gate] = (ms, launches, found, ops.get("pipeline:join", np.nan))
    os.environ.pop("QE_MXU_GATHER", None)
    print(f"phase 5: Query B gate unset {out['unset'][0]:.3f} ms vs set "
          f"{out['set'][0]:.3f} ms per query; the join's device ms "
          f"(program body, profiler) unset {out['unset'][3]:.3f}, set "
          f"{out['set'][3]:.3f} ({out['set'][3] - out['unset'][3]:+.3f})")
    return out


N_PROBE = 1 << 24
# Published dense tensor-core peaks of the H100 SXM (NVIDIA data sheet), in
# operations a second: the one-hot kernels' int8 and bf16 products.
TC_PEAK = {"s8": 1979e12, "bf16": 989e12}
# The product's N as the kernel issues it (padded to whole n8 tiles) and the
# lanes of it the function needs (s8: 16 nibbles and the count; v1: 8 bytes,
# the count and 3 flags; v2: 8 bytes and the count; v4, v5: 9 lanes x 8).
PRODUCT_N = {"s8": (24, 17), "v1": (16, 12), "v2": (16, 9), "v4": (72, 72),
             "v5": (72, 72)}


def design_floor_ms(variant, n):
    """(padded, needed): the least time a one-hot design could take for n
    rows, at the published peak of its type (s8: int8; v1, v2, v4, v5:
    bf16), for the dense product as the kernel issues it
    (probe_agg_variants.FLOPS_PER_ROW) and for its lanes that the function
    needs."""
    from query_engine_tpu_torch.probes.probe_agg_variants import FLOPS_PER_ROW

    peak = TC_PEAK["s8" if variant == "s8" else "bf16"]
    padded = FLOPS_PER_ROW[variant] * n / peak * 1e3
    n_issued, n_needed = PRODUCT_N[variant]
    return padded, padded * n_needed / n_issued


ONEHOT_KERNELS = {  # variant -> (name, source, the TPU kernel it replaces)
    "v1": ("onehot_bytes_v1", "query_engine_tpu_torch/csrc/agg_onehot_bytes.cu",
           "benchmarks/probe_agg_variants.py:39"),
    "v2": ("onehot_bytes_v2", "query_engine_tpu_torch/csrc/agg_onehot_bytes.cu",
           "benchmarks/probe_agg_variants.py:78"),
    "v4": ("onehot_factorized_v4",
           "query_engine_tpu_torch/csrc/agg_onehot_factorized.cu",
           "benchmarks/probe_agg_variants.py:117"),
    "v5": ("onehot_factorized_v5",
           "query_engine_tpu_torch/csrc/agg_onehot_factorized.cu",
           "benchmarks/probe_agg_variants.py:207"),
    "s8": ("onehot_s8", "query_engine_tpu_torch/csrc/agg_onehot_s8.cu",
           "benchmarks/probe_int8_mxu.py:36"),
}


def agg_datasets(n):
    """numpy (values, ok, gid) per data set of phase 6."""
    from query_engine_tpu_torch.probes.probe_agg_variants import probe_data

    out = {"probe data": tuple(t.numpy() for t in probe_data(n, "cpu"))}
    rng = np.random.default_rng(SEED)
    values = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64,
                          endpoint=True)
    values[:2] = [-(2**63), 2**63 - 1]
    ok = rng.random(n) < 0.97
    gid = rng.integers(0, 1024, n).astype(np.int32)
    gid[rng.random(n) < 0.02] = -1
    gid[rng.random(n) < 0.001] = 1024  # just past the groups
    out["all groups and lanes"] = (values, ok, gid)
    sparse = np.full(n, -1, np.int32)
    few = rng.random(n) < 0.01
    sparse[few] = rng.choice([0, 1, 127, 128, 511, 1000, 1023], few.sum())
    near = np.where(rng.random(n) < 0.5, 2**63 - 1 - values % 1000,
                    -(2**63) + values % 1000)
    out["sparse wrap-around"] = (near, ok, sparse)
    return out


def phase6():
    import torch

    from query_engine_tpu_torch.ops import agg_variants as AV
    from query_engine_tpu_torch.ops import group_agg
    from query_engine_tpu_torch.probes import probe_agg_variants as PV
    from query_engine_tpu_torch.probes.probe_int8_mxu import \
        grouped_sum_count_s8

    dev = torch.device("cuda")
    G = PV.G
    n = N_PROBE
    entries = {v: (lambda v_, o, g, v=v: PV.run_variant(v_, o, g, v))
               for v in ("v1", "v2", "v4", "v5")}
    entries["s8"] = lambda v_, o, g: grouped_sum_count_s8(v_, o, g, G)
    main_launches, max_err, times = None, 0, {}
    for name, arrays in agg_datasets(n).items():
        ref_s, ref_c = PV.reference(*arrays)
        values, ok, gid = (torch.from_numpy(a).to(dev) for a in arrays)
        v0_s, v0_c = group_agg.grouped_sum_count(values, ok, gid, G)
        check(np.array_equal(v0_s.cpu().numpy(), ref_s)
              and np.array_equal(v0_c.cpu().numpy(), ref_c),
              f"phase 6 {name}: v0_production differs from the oracle")
        torch.cuda.synchronize()
        reset_counts()
        outs = {v: f(values, ok, gid) for v, f in entries.items()}
        torch.cuda.synchronize()
        launches = read_counts()
        if main_launches is None:
            main_launches = launches
        for v, (s, c) in outs.items():
            check(launches[f"onehot_{v}"] > 0,
                  f"phase 6 {name}: {v} did not launch its kernel")
            check(s.is_cuda and np.array_equal(s.cpu().numpy(), ref_s)
                  and np.array_equal(c.cpu().numpy(), ref_c),
                  f"phase 6 {name}: {v} sums or counts differ from the "
                  "oracle")
            check(torch.equal(s, v0_s) and torch.equal(c, v0_c),
                  f"phase 6 {name}: {v} differs from v0_production")
            s2, c2 = entries[v](values, ok, gid)
            check(torch.equal(s, s2) and torch.equal(c, c2),
                  f"phase 6 {name}: {v}: two runs differ")
        vlo, vhi, gid_m = AV.prepare(values, ok, gid)
        for v in entries:
            kt = AV.chunk_totals_kernel(v, vlo, vhi, gid_m, G)
            kt2 = AV.chunk_totals_kernel(v, vlo, vhi, gid_m, G)
            pt = AV.chunk_totals_plain(v, vlo, vhi, gid_m, G)
            max_err = max(max_err, int((kt - pt).abs().max()))
            check(torch.equal(kt, pt),
                  f"phase 6 {name}: {v} chunk totals != plain")
            check(torch.equal(kt, kt2),
                  f"phase 6 {name}: {v} chunk totals differ between runs")
        print(f"phase 6: {name}: n={n} G={G}: v1 v2 v4 v5 s8 == numpy "
              "oracle == v0_production, chunk totals == plain bit for bit, "
              f"repeat runs bit-identical; launches {launches}")
        if name != "probe data":
            continue
        v0_ms = graph_ms(lambda: group_agg.grouped_sum_count(values, ok, gid,
                                                             G))
        v0_acc_ms = graph_ms(lambda: group_agg.accumulate_kernel(
            [(values, ok)], gid, G))
        lib_ms = graph_ms(index_add_library([(values, ok)], gid, G),
                          iters=5)
        nbytes = values.nbytes + ok.nbytes + gid.nbytes  # 13 B/row
        print(f"phase 6: v0_production {v0_ms:.4f} ms, its accumulate "
              f"kernel alone {v0_acc_ms:.4f} ms; library (index_add_) "
              f"{lib_ms:.4f} ms; bound {bound_ms(nbytes):.4f} ms "
              f"({nbytes} bytes)")
        for v, f in entries.items():
            k_ms = graph_ms(lambda: AV.chunk_totals_kernel(v, vlo, vhi, gid_m,
                                                           G))
            p_ms = graph_ms(lambda: AV.chunk_totals_plain(v, vlo, vhi, gid_m,
                                                          G), iters=5)
            e_ms = cuda_ms(lambda: f(values, ok, gid))
            r = PV.kernel_rates(v, n, k_ms)
            floor_ms, needed_ms = design_floor_ms(v, n)
            times[v] = {"ms": k_ms, "plain_ms": p_ms, "entry_ms": e_ms,
                        "v0_ms": v0_ms, "v0_accumulate_ms": v0_acc_ms,
                        "library_ms": lib_ms, "bound_ms": bound_ms(nbytes)}
            print(f"phase 6: {v}: kernel {k_ms:.4f} ms ({r['rows_per_sec']:.4g}"
                  f" rows/s, {r['tc_tflops']:.2f} TFLOP/s on the tensor cores,"
                  f" {r['gb_per_sec']:.1f} GB/s of input), plain {p_ms:.4f} "
                  f"ms, entry point {e_ms:.4f} ms, v0 {v0_ms:.4f} ms, "
                  f"bound {bound_ms(nbytes):.4f} ms "
                  f"({100 * bound_ms(nbytes) / k_ms:.1f} % of it), design "
                  f"floor (N = {PRODUCT_N[v][0]}, padded) {floor_ms:.4f} ms "
                  f"({100 * floor_ms / k_ms:.1f} % of it), its "
                  f"{PRODUCT_N[v][1]} needed lanes {needed_ms:.4f} ms "
                  f"({100 * needed_ms / k_ms:.1f} %) (device time from CUDA "
                  "graph replays; the entry point's from back-to-back calls, "
                  "CUDA events)")
    return main_launches, max_err, times


def _stats_change(before, after, skip=()):
    return {k: v - before[k] for k, v in after.items()
            if v != before[k] and k not in skip}


def device_ms(sess, query):
    """Kernel time on the card of one warm run of `query` (torch.profiler:
    the sum of the CUDA kernels' own time), that run's wall ms and the
    names of the kernels it ran."""
    import torch

    def run():
        t0 = time.perf_counter()
        sess.sql(query).to_pylist()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prof, _, wall = profiled(run)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == cuda) / 1e3
    names = {e.key for e in events if e.device_type == cuda}
    return busy, wall, names


class IndexAddSpy:
    """While open, counts the `index_add_` calls made on CUDA tensors
    (`Tensor.index_add_`, `Tensor.index_add`, `torch.index_add`), by the
    path and by captures alike, from every thread, except in a thread
    while it is `paused` (the plain versions the checks themselves run)."""

    def __init__(self):
        self.calls = 0
        self._local = threading.local()

    @property
    def paused(self):
        return getattr(self._local, "paused", False)

    @contextlib.contextmanager
    def pause(self):
        was = self.paused
        self._local.paused = True
        try:
            yield
        finally:
            self._local.paused = was

    @contextlib.contextmanager
    def active(self):
        import torch

        saved = [(torch.Tensor, "index_add_"), (torch.Tensor, "index_add"),
                 (torch, "index_add")]
        originals = [getattr(o, n) for o, n in saved]
        lock = threading.Lock()

        def wrap(fn):
            def counted(t, *args, **kwargs):
                if not self.paused and t.is_cuda:
                    with lock:
                        self.calls += 1
                return fn(t, *args, **kwargs)
            return counted

        for (o, n), fn in zip(saved, originals):
            setattr(o, n, wrap(fn))
        try:
            yield self
        finally:
            for (o, n), fn in zip(saved, originals):
                setattr(o, n, fn)


@contextlib.contextmanager
def group_agg_held_against_plain(calls, spy=None):
    """While open, every call of `group_agg.grouped_sums_counts_multi` made
    on CUDA tensors outside a graph capture (the executor's, the segment
    route's, and a program's first run) is held against the plain versions
    on the same tensors: bit for bit against the kernel's plain version
    (`fixed_point` with `accumulate_plain`), counts and integer sums
    exactly and float sums within phase 1's tolerance against float64
    summation. Appends one record per call to `calls`. The plain versions
    launch no kernel, so the launch counts are the path's own."""
    import torch

    from query_engine_tpu_torch.ops import group_agg

    kernel = group_agg.grouped_sums_counts_multi
    pause = spy.pause if spy is not None else contextlib.nullcontext

    def held(items, gid, num_groups):
        got = kernel(items, gid, num_groups)
        if not gid.is_cuda or torch.cuda.is_current_stream_capturing():
            return got
        with pause():
            same = group_agg.fixed_point(items, gid, num_groups,
                                         group_agg.accumulate_plain)
            want = group_agg.grouped_sums_counts_multi_plain(
                items, gid, num_groups)
        shape = f"n={gid.numel()} G={num_groups} item"
        err, n_float = 0.0, 0
        for i, ((v, ok), (s, c), (ps, pc), (ws, wc)) in enumerate(
                zip(items, got, same, want)):
            check(torch.equal(c, pc) and torch.equal(c, wc),
                  f"group_agg at {shape} {i}: counts differ from the plain "
                  "versions")
            check(torch.equal(s.view(torch.int64), ps.view(torch.int64)),
                  f"group_agg at {shape} {i}: sums differ from the kernel's "
                  "plain version")
            if not s.is_floating_point():
                check(torch.equal(s, ws), f"group_agg at {shape} {i}: int "
                      "sums differ from the plain version")
                continue
            n_float += 1
            x = v[ok & torch.isfinite(v)]
            atol = float(x.abs().max()) * ATOL_PER_MAX if x.numel() else 0.0
            close = torch.isclose(s, ws, rtol=RTOL, atol=atol,
                                  equal_nan=True)
            check(bool(close.all()), f"group_agg at {shape} {i}: "
                  f"{int((~close).sum())} float sums outside rtol {RTOL} "
                  f"atol {atol} of float64 summation")
            both = torch.isfinite(s) & torch.isfinite(ws)
            if bool(both.any()):
                err = max(err, float((s - ws)[both].abs().max()))
        calls.append({"n": gid.numel(), "groups": num_groups,
                      "items": len(items), "float_items": n_float,
                      "count_items": sum(v is None for v, _ in items),
                      "max_abs_err": err})
        return got

    group_agg.grouped_sums_counts_multi = held
    try:
        yield
    finally:
        group_agg.grouped_sums_counts_multi = kernel


# the queries whose COUNT, SUM or AVG runs on the card: the bounded GROUP BY
# (Q1, Q5, Q8, Q12), the segment route at 2^23 slots (Q3, Q9, Q10), and the
# ten with subqueries (their grouped subplans' counts and sums, Q16's
# COUNT(DISTINCT) over a deduped ok plane)
TPCH_GROUP_AGG = ("Q1", "Q3", "Q5", "Q8", "Q9", "Q10", "Q12", "Q2", "Q4",
                  "Q11", "Q15", "Q16", "Q17", "Q18", "Q20", "Q21", "Q22")
# tpch_mini's Q11 keeps the parts above 1 % of a nation's stock: none at SF1
TPCH_NO_ROWS_AT_SF1 = ("Q11",)
# a row closer than this to its threshold may fall on the other side
MARGIN_WARN = 1e-12
# the queries whose programs' device time is printed by operator
TPCH_BY_OPERATOR = ("Q1", "Q3", "Q9", "Q10")


def phase7():
    """The 22 TPC-H queries at scale factor 1 through
    Session(device="cuda").sql, each against the numpy oracle."""
    import torch

    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.tpch import data, oracle, queries

    t0 = time.perf_counter()
    tables = data.generate(data.SF1_LINEITEM)
    gen_s = time.perf_counter() - t0
    sess = Session(device="cuda")
    check(sess.executor._compiled, "QE_COMPILED is off in this environment")
    t0 = time.perf_counter()
    data.register(sess, tables)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    sizes = ", ".join(f"{k} {t.num_rows:,}" for k, t in tables.items())
    print(f"phase 7: TPC-H SF1 tables generated on the host in {gen_s:.2f} s "
          f"and registered on the card in {reg_s:.2f} s: {sizes}")
    pipe = sess.executor.pipeline
    timing = ("leaf_ms", "capture_ms")
    out, held = {}, {}
    for q, text in queries.QUERIES.items():
        t0 = time.perf_counter()
        want = oracle.run(q, tables)
        oracle_s = time.perf_counter() - t0
        keys = oracle.FLOAT_SORT_KEYS.get(q, ())
        st0, syncs0 = dict(pipe.stats), sess.executor.host_syncs
        keys0 = set(pipe._cache)
        held[q] = []
        spy = IndexAddSpy()
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held[q], spy):
            t0 = time.perf_counter()
            rows = sess.sql(text).to_pylist()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()["group_agg"]
        first = _stats_change(st0, pipe.stats, timing)
        first_syncs = sess.executor.host_syncs - syncs0
        try:
            err = oracle.compare(rows, want, keys)
        except AssertionError as e:
            raise CheckFailed(f"TPC-H {q} at SF1 differs from the numpy "
                              f"oracle: {e}") from None
        check(len(rows) > 0 or q in TPCH_NO_ROWS_AT_SF1,
              f"TPC-H {q} at SF1 returned no rows")
        walls, leaf_walls, capture_walls = [], [], []
        kinds0 = collections.Counter(pipe.leaf_kinds)
        st1, syncs1 = dict(pipe.stats), sess.executor.host_syncs
        for _ in range(5):
            before = dict(pipe.stats)
            t0 = time.perf_counter()
            with spy.active():
                again = sess.sql(text).to_pylist()
            walls.append((time.perf_counter() - t0) * 1e3)
            leaf_walls.append(pipe.stats["leaf_ms"] - before["leaf_ms"])
            capture_walls.append(pipe.stats["capture_ms"]
                                 - before["capture_ms"])
            try:
                oracle.compare(again, want, keys)
            except AssertionError as e:
                raise CheckFailed(f"TPC-H {q}: a warm run differs from the "
                                  f"oracle: {e}") from None
        ms = statistics.median(walls)
        syncs = (sess.executor.host_syncs - syncs1) / 5
        warm = {k: v / 5
                for k, v in _stats_change(st1, pipe.stats, timing).items()}
        leaves = sorted(pipe.leaf_kinds - kinds0)
        leaf_ms = statistics.median(leaf_walls)
        capture_ms = statistics.median(capture_walls)
        # the ten with subqueries are not run under torch.profiler: a
        # replay inside a profiled run of them crashed the process twice
        # (PERF.md, PR 9); their index_add_ check is the spy's alone
        busy = wall = None
        names = set()
        if q in queries.SUBQUERY_FREE:
            busy, wall, names = device_ms(sess, text)
        by_operator = {}
        if q in TPCH_BY_OPERATOR:  # the query's captured programs
            for key in set(pipe._cache) - keys0:
                if pipe._cache[key].graph is not None:
                    _, ops = profile_program(sess, f"phase 7: {q}",
                                             pipe._cache[key])
                    for name, ms_op in ops.items():
                        by_operator[name] = by_operator.get(name, 0) + ms_op
        captures = warm.get("captures", 0)
        out[q] = {"ms": ms, "first_ms": first_ms, "syncs": syncs,
                  "first_syncs": first_syncs, "first": first, "warm": warm,
                  "captures_per_warm_query": captures,
                  "group_agg": launches, "max_rel_err": err,
                  "rows": len(rows), "eager_leaves": leaves,
                  "leaf_ms": leaf_ms, "capture_ms": capture_ms,
                  "device_ms": busy, "profiled_wall_ms": wall,
                  "by_operator_ms": by_operator,
                  "group_agg_kernels": kernel_names(names, "sum_count_",
                                                    "float_absmax"),
                  # torch's index_add_ kernels (indexFunc{Small,Large}Index)
                  "index_add_kernels": kernel_names(names, "indexFunc"),
                  # index_add_ calls on the card over the first and warm
                  # runs (their captures included), outside the checks
                  "index_add_calls": spy.calls}
        profiled = ("not profiled" if busy is None else
                    f"one profiled run: {busy:.3f} ms of kernel time in "
                    f"{wall:.3f} ms wall, group_agg kernels in it "
                    f"{out[q]['group_agg_kernels']}, index_add_ kernels "
                    f"{out[q]['index_add_kernels']}")
        print(f"phase 7: {q}: {len(rows)} rows == numpy oracle (max rel err "
              f"{err:.3g}, oracle {oracle_s:.2f} s); {ms:.3f} ms/query median "
              f"of 5 warm runs, {syncs:g} host syncs/query, {captures:g} "
              f"captures/warm query; first run "
              f"{first_ms:.1f} ms, {first_syncs} syncs, stats {first}; warm "
              f"stats per query {warm}; eager leaves {leaves} "
              f"{leaf_ms:.3f} ms/query, captures {capture_ms:.3f} ms/query "
              f"(host clock, medians of the same runs); group_agg launches "
              f"{launches}; index_add_ calls {spy.calls}; {profiled}")
        for c in held[q]:
            print(f"phase 7: {q}: group_agg == plain on the same tensors: "
                  f"n={c['n']} G={c['groups']} {c['items']} items "
                  f"({c['float_items']} float, {c['count_items']} count "
                  f"only): bit for bit against the kernel's plain version; "
                  f"against float64 summation counts and int sums exact, "
                  f"float sums within rtol {RTOL} atol max|x|*{ATOL_PER_MAX},"
                  f" max abs err {c['max_abs_err']:.6g}")
    with_agg = [q for q, r in out.items() if r["group_agg"] > 0]
    for q in TPCH_GROUP_AGG:
        check(q in with_agg, f"TPC-H {q}: group_agg did not launch")
        check(out[q]["group_agg_kernels"] or out[q]["device_ms"] is None,
              f"TPC-H {q}: no group_agg kernel in its profiled warm run")
    for q, r in out.items():  # no grouped sum went to a plain index_add_
        check(not r["index_add_kernels"], f"TPC-H {q}: index_add_ kernels "
              f"in its profiled warm run: {r['index_add_kernels']}")
        check(not r["index_add_calls"], f"TPC-H {q}: {r['index_add_calls']} "
              "index_add_ calls on the card in its runs")
    for q in with_agg:
        check(held[q], f"TPC-H {q}: no group_agg call of its first run was "
              "held against the plain version")
    t0 = time.perf_counter()
    margins = oracle.margins(tables)
    for q, m in margins.items():
        if q not in oracle.FLOAT_THRESHOLDS:
            note = (" (an aggregate of integers: exact on the card, so a "
                    "tie resolves as in the oracle)")
        elif m < MARGIN_WARN:
            note = (" -- below 1e-12: a data coincidence the card's "
                    "fixed-point sums may resolve the other way")
        else:
            note = ""
        print(f"phase 7: {q}: the closest row lies {m:.6g} (relative) from "
              f"its threshold in the oracle's float64{note}")
    want = oracle.q11_sf1(tables)
    for run in range(3):
        st0 = dict(pipe.stats)
        rows = sess.sql(queries.Q11_SF1).to_pylist()
        try:
            oracle.compare(rows, want, oracle.FLOAT_SORT_KEYS["Q11"])
        except AssertionError as e:
            raise CheckFailed(f"TPC-H Q11 with FRACTION 0.0001 differs from "
                              f"the oracle (run {run}): {e}") from None
    check(rows, "TPC-H Q11 with FRACTION 0.0001 returned no rows at SF1")
    print(f"phase 7: Q11 with TPC-H's FRACTION for SF1 (0.0001): {len(rows)} "
          f"rows == numpy oracle on a first and two warm runs; last run's "
          f"stats {_stats_change(st0, pipe.stats, timing)} "
          f"({time.perf_counter() - t0:.2f} s with the margins)")
    q6 = out["Q6"]
    check((q6["first"].get("compiles", 0) or q6["first"].get("hits", 0))
          and not q6["first"].get("fallbacks") and not q6["warm"].get(
              "fallbacks"),
          f"Q6 did not run in the compiled pipeline: {q6['first']} "
          f"{q6['warm']}")
    tables_t = oracle.shifted(tables)
    for q, text in queries.SHIFTED.items():
        st0 = dict(pipe.stats)
        rows = sess.sql(text).to_pylist()
        try:
            oracle.compare(rows, tables_t[q])
        except AssertionError as e:
            raise CheckFailed(f"TPC-H {q} with its dates a year later "
                              f"differs from the oracle: {e}") from None
        check(rows != oracle.run(q, tables),
              f"TPC-H {q}: the shifted dates give the old rows")
        print(f"phase 7: {q} with its dates a year later on the same "
              f"Session: rows == numpy oracle {rows}; stats "
              f"{_stats_change(st0, pipe.stats, timing)}")
    total = sum(r["ms"] for r in out.values())
    print(f"phase 7: the 22 queries: {total:.1f} ms in all (sum of the "
          f"medians); group_agg launched in {with_agg}")
    print("phase 7: sized by a count program (joins_counted of the first "
          "run): " + str({q: r["first"]["joins_counted"] for q, r in
                          out.items() if r["first"].get("joins_counted")})
          + "; GROUP BY keys pruned as dependent: "
          + str({q: r["first"]["fd_pruned_keys"] for q, r in out.items()
                 if r["first"].get("fd_pruned_keys")})
          + "; eager HashJoin leaves: "
          + str([q for q, r in out.items() if "HashJoin" in r[
              "eager_leaves"]]))
    return out, held, tables, sess


# node types that must not run as eager leaves of a compiled run, and the
# queries whose string set operations do (two dictionaries merge on the
# host, which a CUDA graph cannot capture)
TRACED_NODES = ("Window", "Distinct", "SetOp")
STRING_SETOPS = ("S3",)


def _float_planes(batch):
    import torch

    return [c.data[:batch.num_rows].clone().view(torch.int64)
            for c in batch.columns if c.data.dtype == torch.float64]


def phase8(tables, sess):
    """The window, DISTINCT, set-operation and CROSS join queries at SF1 on
    phase 7's tables and Session, each against its numpy oracle."""
    import torch

    from query_engine_tpu_torch.tpch import windows

    t_phase = time.perf_counter()
    pipe = sess.executor.pipeline
    timing = ("leaf_ms", "capture_ms")
    out = {}
    for q, text in windows.QUERIES.items():
        t0 = time.perf_counter()
        want = windows.run(q, tables)
        atol = windows.allowance(q, tables)
        oracle_s = time.perf_counter() - t0
        st0, syncs0 = dict(pipe.stats), sess.executor.host_syncs
        kinds0 = collections.Counter(pipe.leaf_kinds)
        keys0 = set(pipe._cache)
        held = []
        spy = IndexAddSpy()
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held, spy):
            t0 = time.perf_counter()
            rows = sess.sql(text).to_pylist()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()["group_agg"]
        first = _stats_change(st0, pipe.stats, timing)
        first_syncs = sess.executor.host_syncs - syncs0
        try:
            err = windows.compare(q, rows, want, atol)
        except AssertionError as e:
            raise CheckFailed(f"{q} at SF1 differs from the numpy oracle: "
                              f"{e}") from None
        check(rows, f"{q} at SF1 returned no rows")
        walls, bits = [], []
        st1, syncs1 = dict(pipe.stats), sess.executor.host_syncs
        for _ in range(5):
            t0 = time.perf_counter()
            with spy.active():
                batch = sess.sql(text)
                again = batch.to_pylist()
            walls.append((time.perf_counter() - t0) * 1e3)
            bits.append(_float_planes(batch))
            if again != rows:  # else equal to the oracle as the first run
                try:
                    windows.compare(q, again, want, atol)
                except AssertionError as e:
                    raise CheckFailed(f"{q}: a warm run differs from the "
                                      f"oracle: {e}") from None
        if q in windows.FLOAT_SUMS:
            check(bits[0] and all(
                torch.equal(a, b) for run in bits[1:]
                for a, b in zip(bits[0], run)),
                f"{q}: a float window sum's bits differ between warm runs")
        ms = statistics.median(walls)
        syncs = (sess.executor.host_syncs - syncs1) / 5
        warm = {k: v / 5
                for k, v in _stats_change(st1, pipe.stats, timing).items()}
        leaves = sorted(pipe.leaf_kinds - kinds0)
        untraced = [k for k in leaves if k in TRACED_NODES
                    and not (k == "SetOp" and q in STRING_SETOPS)]
        check(not untraced, f"{q}: {untraced} ran as eager leaves of a "
              "compiled run")
        sess.executor._compiled = False  # what QE_COMPILED=0 sets
        try:
            t0 = time.perf_counter()
            eager = sess.sql(text).to_pylist()
            eager_ms = (time.perf_counter() - t0) * 1e3
        finally:
            sess.executor._compiled = True
        try:
            eager_err = windows.compare(q, eager, want, atol)
        except AssertionError as e:
            raise CheckFailed(f"{q}: the eager run differs from the oracle: "
                              f"{e}") from None
        busy, wall, names = device_ms(sess, text)
        by_operator = {}
        for key in set(pipe._cache) - keys0:
            if pipe._cache[key].graph is not None:
                _, ops = profile_program(sess, f"phase 8: {q}",
                                         pipe._cache[key])
                for name, ms_op in ops.items():
                    by_operator[name] = by_operator.get(name, 0) + ms_op
        agg_kernels = kernel_names(names, "sum_count_", "float_absmax")
        out[q] = {"rows": len(rows), "ms": ms, "first_ms": first_ms,
                  "syncs": syncs, "first": first, "warm": warm,
                  "eager_leaves": leaves, "eager_ms": eager_ms,
                  "group_agg": launches, "group_agg_kernels": agg_kernels,
                  "index_add_calls": spy.calls,
                  "index_add_kernels": kernel_names(names, "indexFunc"),
                  "max_abs_err": max(err[0], eager_err[0]),
                  "max_rel_err": max(err[1], eager_err[1]),
                  "allowance": atol, "device_ms": busy,
                  "by_operator_ms": by_operator}
        allow = {c: float(f"{v:.6g}") for c, v in atol.items()}
        exception = (" (a string set operation: its two dictionaries merge "
                     "on the host, so on the card it is an eager leaf)"
                     if "SetOp" in leaves else "")
        print(f"phase 8: {q}: {len(rows)} rows == numpy oracle on the first "
              f"and 5 warm compiled runs and the eager run (oracle "
              f"{oracle_s:.2f} s); max abs err {out[q]['max_abs_err']:.6g} "
              f"against the allowance by column {allow}, max rel err "
              f"{out[q]['max_rel_err']:.3g}; {ms:.3f} ms/query median of 5 "
              f"warm runs, {syncs:g} host syncs/query; first run "
              f"{first_ms:.1f} ms, {first_syncs} syncs, stats {first}; warm stats per query {warm}; eager "
              f"leaves {leaves}{exception}; eager run {eager_ms:.1f} ms; "
              f"group_agg launches {launches} (kernels in the profiled run "
              f"{agg_kernels}); index_add_ calls {spy.calls}; one profiled "
              f"warm run: {busy:.3f} ms of kernel time in {wall:.3f} ms "
              f"wall; by operator {by_operator}")
        for c in held:
            print(f"phase 8: {q}: group_agg == plain on the same tensors: "
                  f"n={c['n']} G={c['groups']} {c['items']} items, max abs "
                  f"err against float64 summation {c['max_abs_err']:.6g}")
    for q in windows.GROUP_AGG:
        check(out[q]["group_agg"] > 0, f"{q}: group_agg did not launch")
        check(out[q]["group_agg_kernels"],
              f"{q}: no group_agg kernel in its profiled warm run")
    for q, r in out.items():
        check(not r["index_add_calls"] and not r["index_add_kernels"],
              f"{q}: index_add_ on the card: {r['index_add_calls']} calls, "
              f"kernels {r['index_add_kernels']}")
    total = sum(r["ms"] for r in out.values())
    print(f"phase 8: {len(out)} queries: {total:.1f} ms in all (sum of the "
          f"medians); the phase took {time.perf_counter() - t_phase:.1f} s")
    return out


# the query whose filter and GROUP BY build host tables on purpose (a
# regex match table, UPPER(SPLIT_PART()) and LENGTH once per dictionary
# value), and the eager leaves it may run: its aggregate with its input
STRING_FN_LEAVES = {"F4": ("HashAggregate",)}


def phase9(tables, sess):
    """The statistics, GROUPING(), scalar-function, regex and INTERVAL
    queries of tpch/scalar.py at SF1 on phase 7's tables and Session, each
    against its numpy oracle."""
    from query_engine_tpu_torch.tpch import scalar

    t_phase = time.perf_counter()
    pipe = sess.executor.pipeline
    timing = ("leaf_ms", "capture_ms")
    fac = scalar.cancellation(tables)
    print("phase 9: F1's cancellation factors by group (sum(x^2) / m2 for "
          "sd and vq, |sum(xy)| / |c2| for r, b, a): "
          + "; ".join(f"{g} " + ", ".join(f"{k} {v:.4g}" for k, v in f.items())
                      for g, f in fac.items()))
    margin = scalar.f2_round_margin(tables)
    print(f"phase 9: F2's ROUND(AVG, 2) is {margin:.3g} of a rounding step "
          "from its nearest tie")
    out = {}
    for q, text in scalar.QUERIES.items():
        t0 = time.perf_counter()
        want = scalar.run(q, tables)
        oracle_s = time.perf_counter() - t0
        st0, syncs0 = dict(pipe.stats), sess.executor.host_syncs
        kinds0 = collections.Counter(pipe.leaf_kinds)
        keys0 = set(pipe._cache)
        held = []
        spy = IndexAddSpy()
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held, spy):
            t0 = time.perf_counter()
            batch = sess.sql(text)
            rows = batch.to_pylist()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()["group_agg"]
        first = _stats_change(st0, pipe.stats, timing)
        first_syncs = sess.executor.host_syncs - syncs0
        names_out = batch.schema.names()

        def held_to_oracle(got, run):
            try:
                scalar.compare(q, got, want)
            except AssertionError as e:
                raise CheckFailed(f"{q} at SF1: {run} differs from the numpy "
                                  f"oracle: {e}") from None
            return scalar.float_errors(got, want)

        errs = [held_to_oracle(rows, "the first run")]
        check(rows, f"{q} at SF1 returned no rows")
        walls = []
        st1, syncs1 = dict(pipe.stats), sess.executor.host_syncs
        for i in range(5):
            t0 = time.perf_counter()
            with spy.active():
                again = sess.sql(text).to_pylist()
            walls.append((time.perf_counter() - t0) * 1e3)
            errs.append(held_to_oracle(again, f"warm run {i + 1}"))
        ms = statistics.median(walls)
        syncs = (sess.executor.host_syncs - syncs1) / 5
        warm = {k: v / 5
                for k, v in _stats_change(st1, pipe.stats, timing).items()}
        leaves = sorted(pipe.leaf_kinds - kinds0)
        allowed = STRING_FN_LEAVES.get(q, ())
        check(all(k in allowed for k in leaves),
              f"{q}: {leaves} ran as eager leaves of a compiled run")
        if q in scalar.GROUP_AGG:
            check(not warm.get("captures"),
                  f"{q}: a warm run captured again ({warm})")
        sess.executor._compiled = False  # what QE_COMPILED=0 sets
        try:
            t0 = time.perf_counter()
            eager = sess.sql(text).to_pylist()
            eager_ms = (time.perf_counter() - t0) * 1e3
        finally:
            sess.executor._compiled = True
        errs.append(held_to_oracle(eager, "the eager run"))
        busy, wall, names = device_ms(sess, text)
        by_operator = {}
        for key in set(pipe._cache) - keys0:
            if pipe._cache[key].graph is not None:
                _, ops = profile_program(sess, f"phase 9: {q}",
                                         pipe._cache[key])
                for name, ms_op in ops.items():
                    by_operator[name] = by_operator.get(name, 0) + ms_op
        agg_kernels = kernel_names(names, "sum_count_", "float_absmax")
        col_err = {}
        for e in errs:
            for c, v in e.items():
                col_err[names_out[c]] = max(col_err.get(names_out[c], 0.0), v)
        out[q] = {"rows": len(rows), "ms": ms, "first_ms": first_ms,
                  "syncs": syncs, "first": first, "warm": warm,
                  "eager_leaves": leaves, "eager_ms": eager_ms,
                  "group_agg": launches, "group_agg_kernels": agg_kernels,
                  "index_add_calls": spy.calls,
                  "index_add_kernels": kernel_names(names, "indexFunc"),
                  "max_rel_err": col_err, "device_ms": busy,
                  "by_operator_ms": by_operator}
        errs_s = {c: float(f"{v:.3g}") for c, v in col_err.items()}
        exception = (" (its string functions build host tables: eager leaves "
                     "by design)" if leaves else "")
        print(f"phase 9: {q}: {len(rows)} rows == numpy oracle on the first "
              f"and 5 warm compiled runs and the eager run (oracle "
              f"{oracle_s:.2f} s); largest relative error by float column "
              f"{errs_s}; {ms:.3f} ms/query median of 5 warm runs, "
              f"{syncs:g} host syncs/query; first run {first_ms:.1f} ms, "
              f"{first_syncs} syncs, stats {first}; warm stats per query "
              f"{warm}; eager leaves {leaves}{exception}; eager run "
              f"{eager_ms:.1f} ms; group_agg launches {launches} (kernels in "
              f"the profiled run {agg_kernels}); index_add_ calls "
              f"{spy.calls}; one profiled warm run: {busy:.3f} ms of kernel "
              f"time in {wall:.3f} ms wall; by operator {by_operator}")
        print(f"phase 9: {q}: rows {rows if len(rows) <= 32 else rows[:8]}")
        for c in held:
            print(f"phase 9: {q}: group_agg == plain on the same tensors: "
                  f"n={c['n']} G={c['groups']} {c['items']} items, max abs "
                  f"err against float64 summation {c['max_abs_err']:.6g}")
    for q in scalar.GROUP_AGG:
        check(out[q]["group_agg"] > 0, f"{q}: group_agg did not launch")
        check(out[q]["group_agg_kernels"],
              f"{q}: no group_agg kernel in its profiled warm run")
    for q, r in out.items():
        check(not r["index_add_calls"] and not r["index_add_kernels"],
              f"{q}: index_add_ on the card: {r['index_add_calls']} calls, "
              f"kernels {r['index_add_kernels']}")
    total = sum(r["ms"] for r in out.values())
    print(f"phase 9: {len(out)} queries: {total:.1f} ms in all (sum of the "
          f"medians); the phase took {time.perf_counter() - t_phase:.1f} s")
    return out


# the statements whose COUNT, SUM or AVG must launch group_agg on the card
ORDERED_GROUP_AGG = ("O1", "O3", "O6")


def device_by_node(sess, query):
    """One warm run of `query` under torch.profiler, each plan node the
    executor runs inside a `node:<kind>` range: the kernel time on the card
    (the sum of the CUDA kernels' own time, the ranges' spans on the
    device's timeline left out), the run's wall ms, the kernels' names, the
    kernel ms by plan node (each kernel charged to the innermost node range
    it was launched in; a replayed program's kernels to the node that
    replayed it) and the five kernels that took longest."""
    import torch

    from query_engine_tpu_torch.engine.executor import QueryExecutor

    real = QueryExecutor._execute_node

    def ranged(self, plan, _skip_compiled=False):
        with torch.profiler.record_function(
                f"node:{type(plan).__name__.removeprefix('P')}"):
            return real(self, plan, _skip_compiled)

    def run():
        t0 = time.perf_counter()
        sess.sql(query).to_pylist()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    QueryExecutor._execute_node = ranged
    try:
        prof, _, wall = profiled(run)
    finally:
        QueryExecutor._execute_node = real
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels = [e for e in prof.key_averages() if e.device_type == cuda
               and not e.key.startswith(("node:", "pipeline:"))]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    names = {e.key for e in kernels}
    top = {e.key[:60]: round(e.self_device_time_total / 1e3, 3)
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
           [:5]}
    by_node = collections.Counter()
    for fe in prof.events():
        if fe.device_type != cpu or fe.is_async or not fe.kernels:
            continue
        owner = fe
        while owner is not None and not owner.name.startswith("node:"):
            owner = owner.cpu_parent
        node = owner.name[len("node:"):] if owner is not None else "outside"
        by_node[node] += sum(k.duration for k in fe.kernels) / 1e3
    by_node = {k: round(v, 3) for k, v in by_node.most_common()}
    return busy, wall, names, by_node, top


def phase10(tables, sess):
    """The ordered-set, STRING_AGG, ARRAY_AGG/UNNEST, LIST-function and
    WITH RECURSIVE statements of tpch/ordered.py at SF1 on phase 7's tables
    and Session, each against its numpy oracle."""
    import torch

    from query_engine_tpu_torch.tpch import ordered

    t_phase = time.perf_counter()
    ex = sess.executor
    pipe = ex.pipeline
    timing = ("leaf_ms", "capture_ms")
    out = {}
    for q, text in ordered.QUERIES.items():
        t0 = time.perf_counter()
        want = ordered.run(q, tables)
        oracle_s = time.perf_counter() - t0

        def held_to_oracle(got, run):
            try:
                return ordered.compare(q, got, want)
            except AssertionError as e:
                raise CheckFailed(f"{q} at SF1: {run} differs from the numpy "
                                  f"oracle: {e}") from None

        st0, syncs0 = dict(pipe.stats), ex.host_syncs
        kinds0 = collections.Counter(pipe.leaf_kinds)
        keys0 = set(pipe._cache)
        host0 = dict(ex.host_ms)
        mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        held = []
        spy = IndexAddSpy()
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held, spy):
            t0 = time.perf_counter()
            rows = sess.sql(text).to_pylist()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()["group_agg"]
        first = _stats_change(st0, pipe.stats, timing)
        first_syncs = ex.host_syncs - syncs0
        first_rec = dict(sess.recursion) if q == "O6" else None
        errs = [held_to_oracle(rows, "the first run")]
        check(rows, f"{q} at SF1 returned no rows")
        walls = []
        st1, syncs1 = dict(pipe.stats), ex.host_syncs
        host1 = dict(ex.host_ms)
        dedup_ms = 0.0
        for i in range(5):
            t0 = time.perf_counter()
            with spy.active():
                again = sess.sql(text).to_pylist()
            walls.append((time.perf_counter() - t0) * 1e3)
            if q == "O6":
                dedup_ms += sess.recursion["dedup_ms"]
            errs.append(held_to_oracle(again, f"warm run {i + 1}"))
        ms = statistics.median(walls)
        syncs = (ex.host_syncs - syncs1) / 5
        warm = {k: v / 5
                for k, v in _stats_change(st1, pipe.stats, timing).items()}
        warm_host = {k: round((pipe.stats[k] - st1[k]) / 5, 3)
                     for k in timing}
        host_warm = {k: round((v - host1.get(k, 0.0)) / 5, 3)
                     for k, v in ex.host_ms.items() if v != host1.get(k, 0.0)}
        if q == "O6":
            host_warm["recursion_dedup"] = round(dedup_ms / 5, 3)
        leaves = sorted(pipe.leaf_kinds - kinds0)
        entries = len(set(pipe._cache) - keys0)
        mem_warm = (torch.cuda.memory_allocated(),
                    torch.cuda.memory_reserved())
        ex._compiled = False  # what QE_COMPILED=0 sets
        try:
            t0 = time.perf_counter()
            with spy.active():
                eager = sess.sql(text).to_pylist()
            eager_ms = (time.perf_counter() - t0) * 1e3
        finally:
            ex._compiled = True
        errs.append(held_to_oracle(eager, "the eager run"))
        with spy.active():
            busy, wall, names, by_node, top = device_by_node(sess, text)
        agg_kernels = kernel_names(names, "sum_count_", "float_absmax")
        out[q] = {"rows": len(rows), "ms": ms, "first_ms": first_ms,
                  "syncs": syncs, "first": first, "warm": warm,
                  "eager_leaves": leaves, "eager_ms": eager_ms,
                  "host_ms": host_warm, "group_agg": launches,
                  "group_agg_kernels": agg_kernels,
                  "index_add_calls": spy.calls,
                  "index_add_kernels": kernel_names(names, "indexFunc"),
                  "max_rel_err": max(errs), "device_ms": busy,
                  "by_node_ms": by_node, "top_kernels_ms": top,
                  "cache_entries": entries, "warm_host_ms": warm_host}
        print(f"phase 10: {q}: {len(rows)} rows == numpy oracle on the first "
              f"and 5 warm compiled runs and the eager run (oracle "
              f"{oracle_s:.2f} s); largest relative float error "
              f"{max(errs):.3g}; {ms:.3f} ms/query median of 5 warm runs, "
              f"{syncs:g} host syncs/query; first run {first_ms:.1f} ms, "
              f"{first_syncs} syncs, stats {first}; warm stats per query "
              f"{warm}, host ms in eager leaves and captures {warm_host}; "
              f"eager leaves {leaves}; host ms of host finalization per warm "
              f"query {host_warm}; eager run {eager_ms:.1f} ms; "
              f"group_agg launches {launches} (kernels in the profiled run "
              f"{agg_kernels}); index_add_ calls {spy.calls}; one profiled "
              f"warm run: {busy:.3f} ms of kernel time in {wall:.3f} ms "
              f"wall; kernel ms by plan node {by_node}; longest kernels "
              f"{top}")
        if q == "O6":
            out[q]["recursion"] = first_rec
            print(f"phase 10: O6: {first_rec['iterations']} rounds; the first "
                  f"run captured {first.get('captures', 0)} graphs and "
                  f"compiled {first.get('compiles', 0)} programs, a warm run "
                  f"captured {warm.get('captures', 0):g}; the recursion left "
                  f"{entries} pipeline cache entries; device memory allocated "
                  f"(reserved) {mem0[0] / 2**20:.1f} ({mem0[1] / 2**20:.1f}) "
                  f"MiB before the first run, {mem_warm[0] / 2**20:.1f} "
                  f"({mem_warm[1] / 2**20:.1f}) MiB after the warm runs")
            check(first_rec["iterations"] == ordered.RECURSION_DEPTH,
                  f"O6 ran {first_rec['iterations']} rounds, not "
                  f"{ordered.RECURSION_DEPTH}")
        print(f"phase 10: {q}: rows {rows if len(rows) <= 8 else rows[:4]}")
        for c in held:
            print(f"phase 10: {q}: group_agg == plain on the same tensors: "
                  f"n={c['n']} G={c['groups']} {c['items']} items, max abs "
                  f"err against float64 summation {c['max_abs_err']:.6g}")
    for q in ORDERED_GROUP_AGG:
        check(out[q]["group_agg"] > 0, f"{q}: group_agg did not launch")
    for q, r in out.items():
        check(not r["index_add_calls"] and not r["index_add_kernels"],
              f"{q}: index_add_ on the card: {r['index_add_calls']} calls, "
              f"kernels {r['index_add_kernels']}")
    total = sum(r["ms"] for r in out.values())
    print(f"phase 10: {len(out)} statements: {total:.1f} ms in all (sum of "
          f"the medians); the phase took {time.perf_counter() - t_phase:.1f} "
          "s")
    return out


# phase 11: the refresh sets' seeds, and the allocated memory M14 may gain
# from its round 2 to its round 3 (the staging tables registered anew, the
# allocator's rounding)
RF_SEED = 20260517
M14_SLACK = 64 << 20


def _index_build_timer(builds):
    """While open, each index build of a table (CREATE INDEX, a rebuild
    after a replace, an append's rows) appends (rows, ms) to `builds`."""
    from query_engine_tpu_torch.storage.memory import MemoryDataSource

    real = MemoryDataSource._insert_into_index

    def timed(self, idx_name, columns, batch, start_row):
        t0 = time.perf_counter()
        real(self, idx_name, columns, batch, start_row)
        builds.append((batch.num_rows, (time.perf_counter() - t0) * 1e3))

    @contextlib.contextmanager
    def active():
        MemoryDataSource._insert_into_index = timed
        try:
            yield
        finally:
            MemoryDataSource._insert_into_index = real

    return active()


def _mib(n):
    return f"{n / 2**20:.1f} MiB"


def phase11(tables):
    """The Session surface at SF1: TPC-H's refresh functions, indexes and
    parameters, UPDATE, ON CONFLICT, a transaction, views, DDL, the result
    cache and rounds of refreshes, each statement against the numpy oracle
    on the edited tables."""
    import gc

    import torch

    from query_engine_tpu_torch.engine.session import Session, _bind_params
    from query_engine_tpu_torch.index import native
    from query_engine_tpu_torch.plan.lowering import Lowering
    from query_engine_tpu_torch.sql.parser import parse_sql
    from query_engine_tpu_torch.tpch import data, oracle, refresh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    sess = Session(device="cuda")
    data.register(sess, tables)
    torch.cuda.synchronize()
    mem_reg = torch.cuda.memory_allocated()
    ex, pipe = sess.executor, sess.executor.pipeline
    st = refresh.State(dict(tables))
    count = refresh.refresh_count(data.SF1_LINEITEM)
    rf = refresh.make_rf1(st, count, RF_SEED)
    refresh.register_staging(sess, rf)
    print(f"phase 11: device memory allocated (reserved) {_mib(mem0[0])} "
          f"({_mib(mem0[1])}) with the earlier Sessions freed, "
          f"{_mib(mem_reg)} with the SF1 tables registered; native index "
          f"library {native.native_available()}; a refresh is {count} "
          f"orders, RF1 {rf.lineitem.num_rows} lineitems")
    out, builds = [], []
    spy = IndexAddSpy()
    launches = collections.Counter()

    def run(step, s=sess, warm=True):
        want = step.want(st) if step.want is not None else None
        e = s.executor
        syncs0, scans0, n_builds = e.host_syncs, e.index_scans, len(builds)
        held = []
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held, spy):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = refresh.run_step(s, step)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        n_launch = read_counts()["group_agg"]
        launches[step.label] += n_launch
        syncs = e.host_syncs - syncs0
        if want is not None:
            try:
                oracle.compare(rows, want, step.float_keys)
            except AssertionError as err:
                raise CheckFailed(f"{step.label}: {step.sql[:100]}: differs "
                                  f"from the numpy oracle: {err}") from None
        if step.index_scan:
            bound = _bind_params(parse_sql(step.sql), step.params)
            text = Lowering(s.sources).lower(s._plan_query(bound)).pretty()
            check("IndexScan" in text, f"{step.label}: no IndexScan in the "
                  f"lowered plan of {step.sql}: {text}")
            check(e.index_scans == scans0 + 1, f"{step.label}: the executor "
                  f"ran {e.index_scans - scans0} index scans for {step.sql}")
        if step.edit is not None:
            step.edit(st)
        warm_ms = None
        read_only = step.sql.lstrip().upper().startswith("SELECT")
        if warm and read_only and not step.script:
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                with spy.active():
                    again = refresh.run_step(s, step)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                if want is not None:
                    try:
                        oracle.compare(again, want, step.float_keys)
                    except AssertionError as err:
                        raise CheckFailed(f"{step.label}: a warm run of "
                                          f"{step.sql[:100]} differs from "
                                          f"the oracle: {err}") from None
            warm_ms = statistics.median(walls)
        rec = {"label": step.label, "sql": " ".join(step.sql.split())[:72],
               "rows": len(rows), "first_ms": first_ms, "warm_ms": warm_ms,
               "syncs": syncs, "group_agg": n_launch,
               "index_builds": builds[n_builds:]}
        out.append(rec)
        shown = rows if len(rows) <= 3 else rows[:2] + ["..."]
        warm_txt = "" if warm_ms is None else f", warm {warm_ms:.3f} ms"
        build_txt = "" if not rec["index_builds"] else (
            ", index builds (rows, ms) " + ", ".join(
                f"({n:,}, {ms:.1f})" for n, ms in rec["index_builds"]))
        print(f"phase 11: {step.label}: {rec['sql']}: {len(rows)} rows "
              f"== oracle {shown}; first {first_ms:.3f} ms{warm_txt}; "
              f"{syncs} host syncs; group_agg {n_launch}{build_txt}")
        for c in held:
            print(f"phase 11: {step.label}: group_agg == plain on the same "
                  f"tensors: n={c['n']} G={c['groups']} {c['items']} items, "
                  f"max abs err against float64 summation "
                  f"{c['max_abs_err']:.6g}")
        return rows

    with _index_build_timer(builds):
        for step in refresh.steps(st, count, RF_SEED, rf):
            run(step)
        rf2 = refresh.make_rf1(st, count, RF_SEED + 1)
        refresh.register_staging(sess, rf2)
        for step in refresh.transaction_steps(st, count, RF_SEED + 1, rf2):
            run(step)
        for step in refresh.ddl_steps(st):
            run(step)
        check(not sess.in_transaction(), "M10 left a transaction open")

        # M13: a Session with the result cache, over lineitem
        csess = Session(device="cuda", enable_cache=True)
        csess.register_table("lineitem", tables["lineitem"].to_batch("cuda"))
        cst = refresh.State(dict(tables))
        q1 = refresh._query("Q1", "M13")
        cpipe = csess.executor.pipeline
        st_main, st = st, cst
        try:
            run(q1, csess, warm=False)
            stats0, syncs0 = dict(cpipe.stats), csess.executor.host_syncs
            reset_counts()
            run(q1, csess, warm=False)
            check(read_counts()["group_agg"] == 0 and cpipe.stats == stats0
                  and csess.executor.host_syncs == syncs0
                  and csess._cache.stats.hits == 1,
                  f"M13: the repeated Q1 was not a cache hit that runs no "
                  f"program: stats {_stats_change(stats0, cpipe.stats)}, "
                  f"{csess.executor.host_syncs - syncs0} syncs, "
                  f"{read_counts()['group_agg']} group_agg launches, "
                  f"{csess._cache.stats.snapshot()}")
            keys = refresh.rf2_keys(cst, count)
            run(refresh.rf2_steps(cst, keys, "M13")[0], csess)
            refresh.apply_rf2(cst, keys)
            check(len(csess._cache) == 0, "M13: the DELETE left the result "
                  "cache full")
            run(q1, csess, warm=False)
            check(csess._cache.stats.misses == 2, "M13: the Q1 after the "
                  f"DELETE was not a miss: {csess._cache.stats.snapshot()}")
        finally:
            st = st_main
        del csess, cpipe
        gc.collect()

        # M14: rounds of RF1, RF2 and Q1
        def rounds(n, seed, tag):
            mem = []
            for r in range(n):
                rfr = refresh.make_rf1(st, count, seed + r)
                refresh.register_staging(sess, rfr)
                for step in refresh.rf1_steps(st, rfr, tag):
                    run(step, warm=False)
                for step in refresh.rf2_steps(st, refresh.rf2_keys(st, count),
                                              tag):
                    run(step, warm=False)
                run(refresh._query("Q1", tag), warm=False)
                gc.collect()
                torch.cuda.synchronize()
                mem.append((torch.cuda.memory_allocated(),
                            torch.cuda.memory_reserved(), len(pipe._cache)))
            return mem

        mem14 = rounds(3, RF_SEED + 10, "M14")
        real_drop = pipe.drop_entries_reading
        pipe.drop_entries_reading = lambda sources: 0
        try:
            mem_off = rounds(2, RF_SEED + 20, "M14b")
        finally:
            pipe.drop_entries_reading = real_drop
    for tag, mem in (("M14", mem14), ("M14 with the dropping off", mem_off)):
        print(f"phase 11: {tag}: after each round allocated (reserved) "
              + ", ".join(f"{_mib(a)} ({_mib(r)}), {n} programs"
                          for a, r, n in mem))
    growth = mem14[2][0] - mem14[1][0]
    check(growth <= M14_SLACK, f"M14: allocated memory grew by "
          f"{_mib(growth)} from round 2 to round 3 (slack "
          f"{_mib(M14_SLACK)})")
    for label in ("M5", "M7"):
        check(launches[label] > 0, f"{label}: group_agg did not launch")
    check(not spy.calls, f"phase 11: {spy.calls} index_add_ calls on the card")
    # the closures hold the Session too
    del sess, pipe, ex, run, rounds, real_drop
    gc.collect()
    torch.cuda.synchronize()
    mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    print(f"phase 11: {len(out)} statements == oracle; group_agg launches by "
          f"statement group {dict(launches)}; index builds (rows, ms) "
          f"{[(n, round(ms, 1)) for n, ms in builds]}; M14 allocated growth "
          f"round 2 -> 3 {_mib(growth)}; memory allocated (reserved) before "
          f"{_mib(mem0[0])} ({_mib(mem0[1])}), after the phase's Sessions "
          f"are freed {_mib(mem1[0])} ({_mib(mem1[1])}); the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"statements": out, "launches": dict(launches),
            "index_builds": builds, "m14": mem14, "m14_off": mem_off}


# ---- phase 12: the host services over the card ----------------------------
PG_CONNECTIONS = 4
PG_WARM_ALONE = 3      # warm runs of each query on one connection alone
Q6_PARAM_SETS = (["1994-01-01", 0.06, 24], ["1993-01-01", 0.05, 25],
                 ["1995-01-01", 0.07, 24], ["1996-01-01", 0.03, 30],
                 ["1997-01-01", 0.08, 20])
Q6_PARAM_OIDS = [1082, 701, 20]  # date, float8, int8
PG_USER, PG_PASSWORD = "tpch", "sf1-secret"
STREAM_BATCH = 1 << 16
WINDOW_BATCHES = 8
CLI_ROWS = 1 << 23
CLI_QUERY = (f"SELECT x % 16 AS k, COUNT(*) AS n, SUM(x) AS s, MIN(x) AS lo "
             f"FROM GENERATE_SERIES(1, {CLI_ROWS}) AS g(x) GROUP BY x % 16 "
             "ORDER BY k")


def _copy_text(t, row):
    """One row of a host table as COPY's text renders it (str of the
    Python value, a DATE in ISO form)."""
    import datetime

    from query_engine_tpu_torch.tpch.data import EPOCH

    out = []
    for f in t.fields:
        v = t.columns[f.name][row]
        kind = f.data_type.kind.value
        if f.name in t.dicts:
            out.append(str(t.dicts[f.name][v]))
        elif kind == "Date32":
            out.append(str(EPOCH + datetime.timedelta(days=int(v))))
        elif kind.startswith("Float"):
            out.append(str(float(v)))
        else:
            out.append(str(int(v)))
    return "\t".join(out)


def _oracle_equal(label, rows, want, keys=()):
    from query_engine_tpu_torch.tpch import oracle

    try:
        return oracle.compare(rows, want, keys)
    except AssertionError as e:
        raise CheckFailed(f"{label}: differs from the numpy oracle: "
                          f"{e}") from None


def _read_paths_ms(batch, reps=5):
    """Host ms (medians of `reps`) of reading `batch` to Python values in
    one packed transfer (`host_pylists`, the one path) and a column at a
    time (`Column.to_pylist`, two transfers a column); the two must
    agree."""
    def timed(read):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            vals = read()
            walls.append((time.perf_counter() - t0) * 1e3)
        return vals, statistics.median(walls)

    packed, packed_ms = timed(batch.host_pylists)
    per_col, per_col_ms = timed(lambda: [c.to_pylist(batch.num_rows)
                                         for c in batch.columns])
    check(packed == per_col, "phase 12a: the packed read differs from the "
          "column-at-a-time read")
    return packed_ms, per_col_ms


@contextlib.contextmanager
def _server_records(sess, server_mod):
    """While open, each statement the Session executes (in the server's
    thread) is recorded by its SQL text: its ms (host clock to the end of
    torch.cuda.synchronize()), its group_agg launches, and the host ms and
    rows of the encoding of its result into DataRows."""
    import torch

    from query_engine_tpu_torch.ops import group_agg

    records = collections.defaultdict(list)
    last = {"rec": None}
    real_exec, real_enc = sess.execute_statement, server_mod.batch_to_data_rows

    def recorded(stmt, sql_text=""):
        n0 = group_agg.launches
        t0 = time.perf_counter()
        out = real_exec(stmt, sql_text=sql_text)
        if sess.device.type == "cuda":
            torch.cuda.synchronize()
        rec = {"ms": (time.perf_counter() - t0) * 1e3,
               "group_agg": group_agg.launches - n0, "encode_ms": None}
        records[sql_text].append(rec)
        last["rec"] = rec
        return out

    def encoded(batch):
        t0 = time.perf_counter()
        rows = real_enc(batch)
        rec, last["rec"] = last["rec"], None
        if rec is not None:
            rec["encode_ms"] = (time.perf_counter() - t0) * 1e3
        return rows

    sess.execute_statement = recorded
    server_mod.batch_to_data_rows = encoded
    try:
        yield records
    finally:
        del sess.execute_statement
        server_mod.batch_to_data_rows = real_enc


def phase12a(tables, sess):
    """pgwire over the card's Session: the 22 TPC-H queries from 4
    connections, Q6 by the extended protocol, RF1 by COPY FROM and RF2 by
    DELETE, COPY TO, a transaction, the catalog, a cursor and SCRAM."""
    import concurrent.futures

    from query_engine_tpu_torch.pgwire import server as pg
    from query_engine_tpu_torch.pgwire.auth import AuthConfig, AuthMethod
    from query_engine_tpu_torch.pgwire.result import type_oid
    from query_engine_tpu_torch.tpch import oracle, queries, refresh
    # the test helpers, from this checkout's tests/ (a `tests` package
    # elsewhere on the path may shadow the directory)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from pg_client import PgTestClient
    from torch_pg_wire import ServerThread, WireClient

    t0 = time.perf_counter()
    wants = {q: oracle.run(q, tables) for q in queries.QUERIES}
    oracle_s = time.perf_counter() - t0
    names = list(queries.QUERIES)
    server = pg.PgServer(sess, "127.0.0.1", 0)
    auth_server = pg.PgServer(sess, "127.0.0.1", 0, auth=AuthConfig(
        AuthMethod.SCRAM_SHA_256, {PG_USER: PG_PASSWORD}))
    held, spy = [], IndexAddSpy()
    out = {"queries": {}, "held": held}

    def run_query(c, q, want=None):
        """(send time, wire ms, RowDescription fields, rows) of one query,
        its rows held against the oracle."""
        t_send = time.perf_counter()
        msgs = c.query_raw(queries.QUERIES[q])
        wire = (time.perf_counter() - t_send) * 1e3
        fields, rows, tags = c.typed(msgs)
        _oracle_equal(f"phase 12a: {q} over the wire", rows,
                      wants[q] if want is None else want,
                      oracle.FLOAT_SORT_KEYS.get(q, ()))
        check(tags == [f"SELECT {len(rows)}"], f"phase 12a: {q}: {tags}")
        return t_send, wire, fields, len(rows)

    def connection(i):
        """Connection i sends all the queries, from the (5i mod 22)-th on,
        so first runs and warm runs interleave across connections."""
        order = [names[(5 * i + k) % len(names)] for k in range(len(names))]
        c = WireClient("127.0.0.1", srv.ports[0])
        try:
            return [(q,) + run_query(c, q) for q in order]
        finally:
            c.close()

    reset_counts()
    srv = ServerThread(server, auth_server).start()
    try:
        with spy.active(), group_agg_held_against_plain(held, spy), \
                _server_records(sess, pg) as records:
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(PG_CONNECTIONS) as ex:
                futures = [ex.submit(connection, i)
                           for i in range(PG_CONNECTIONS)]
                per_conn = [f.result() for f in futures]
            concurrent_s = time.perf_counter() - t0
            c = WireClient("127.0.0.1", srv.ports[0])
            alone = {q: [run_query(c, q)[1] for _ in range(PG_WARM_ALONE)]
                     for q in names}
            wire_recs = {q: list(records[queries.QUERIES[q]])
                         for q in names}
            # the same Session in this process, under its lock
            in_proc, schemas, reads = {}, {}, {}
            with sess.lock:
                for q in names:
                    walls = []
                    for _ in range(3):
                        t1 = time.perf_counter()
                        res = sess.sql(queries.QUERIES[q])
                        res.to_pylist()
                        walls.append((time.perf_counter() - t1) * 1e3)
                    in_proc[q] = statistics.median(walls)
                    schemas[q] = [(f.name.rsplit(".", 1)[-1],
                                   type_oid(f.data_type)) for f in res.schema]
                    reads[q] = _read_paths_ms(res)
            runs = collections.defaultdict(list)
            for conn in per_conn:
                for q, t_send, wire, fields, n in conn:
                    check(fields == schemas[q], f"phase 12a: {q}: "
                          f"RowDescription {fields} != the schema's "
                          f"{schemas[q]}")
                    runs[q].append((t_send, wire, n))
            for q in names:
                recs = wire_recs[q]
                first = min(runs[q])
                warm = [w for t, w, n in runs[q] if (t, w, n) != first]
                r = out["queries"][q] = {
                    "rows": first[2], "first_wire_ms": first[1],
                    "warm_wire_ms_concurrent": statistics.median(warm),
                    "warm_wire_ms_alone": statistics.median(alone[q]),
                    "session_sql_warm_ms": in_proc[q],
                    "server_first_ms": recs[0]["ms"],
                    "server_warm_ms": statistics.median(
                        x["ms"] for x in recs[1:]),
                    "encode_ms": statistics.median(
                        x["encode_ms"] for x in recs),
                    "group_agg": sum(x["group_agg"] for x in recs),
                    "read_ms_packed": reads[q][0],
                    "read_ms_per_column": reads[q][1]}
                print(f"phase 12a: {q}: {r['rows']} rows == numpy oracle on "
                      f"all {len(recs)} wire runs; wire first "
                      f"{r['first_wire_ms']:.3f} ms, warm "
                      f"{r['warm_wire_ms_concurrent']:.3f} ms with "
                      f"{PG_CONNECTIONS} connections, "
                      f"{r['warm_wire_ms_alone']:.3f} ms alone; Session.sql "
                      f"warm {r['session_sql_warm_ms']:.3f} ms in process; "
                      f"server first {r['server_first_ms']:.3f} ms, warm "
                      f"{r['server_warm_ms']:.3f} ms, encoding "
                      f"{r['encode_ms']:.3f} ms (host); the result's "
                      f"read to Python {r['read_ms_packed']:.3f} ms packed, "
                      f"{r['read_ms_per_column']:.3f} ms a column at a time"
                      f"; group_agg {r['group_agg']}")
            print(f"phase 12a: the 22 results read to Python: "
                  f"{sum(x[0] for x in reads.values()):.3f} ms packed (one "
                  f"transfer each), "
                  f"{sum(x[1] for x in reads.values()):.3f} ms a column at "
                  f"a time (two transfers a column), medians of 5")
            print(f"phase 12a: {PG_CONNECTIONS} connections x {len(names)} "
                  f"queries, each connection starting 5 queries on, in "
                  f"{concurrent_s:.2f} s; RowDescription names and OIDs == "
                  f"the schema's; oracles {oracle_s:.2f} s before")

            # Q6 by the extended protocol: Parse once, Describe, 5 Binds
            c.parse("q6", refresh.Q6_PARAM, Q6_PARAM_OIDS)
            c.describe("S", "q6")
            described = c.sync()
            tags = [t for t, _ in described]
            check(tags == [b"1", b"t", b"T", b"Z"], f"phase 12a: Q6 Parse "
                  f"and Describe gave {tags}")
            p_oids = WireClient.parameter_oids(described[1][1])
            fields = c.typed(described)[0]
            check(p_oids == Q6_PARAM_OIDS and fields == [("revenue", 701)],
                  f"phase 12a: Q6 Describe: parameters {p_oids}, fields "
                  f"{fields}")
            ext_ms = []
            for params in Q6_PARAM_SETS:
                t1 = time.perf_counter()
                c.bind("q6", params)
                c.execute()
                got = c.sync()
                ext_ms.append((time.perf_counter() - t1) * 1e3)
                _, rows, _ = c.typed([described[2]] + got)
                _oracle_equal(f"phase 12a: Q6 with {params}", rows,
                              refresh.q6_rows(tables, *params))
            print(f"phase 12a: Q6 with $1-$3 parsed once; Describe gives "
                  f"parameter OIDs {p_oids}, fields {fields}; 5 Bind/Execute "
                  f"== oracle in {[round(x, 3) for x in ext_ms]} ms")

            # RF1 by COPY FROM STDIN, RF2 by DELETE, then Q1, Q3, Q18
            st = refresh.State(dict(tables))
            count = refresh.refresh_count(tables["lineitem"].num_rows)
            rf = refresh.make_rf1(st, count, RF_SEED + 40)
            copy_ms = {}
            for name, t in (("orders", rf.orders), ("lineitem", rf.lineitem)):
                lines = [_copy_text(t, r) for r in range(t.num_rows)]
                t1 = time.perf_counter()
                tag = c.copy_in(f"COPY {name} FROM STDIN", lines)
                copy_ms[name] = (time.perf_counter() - t1) * 1e3
                check(tag == f"COPY {t.num_rows}", f"phase 12a: COPY {name} "
                      f"FROM STDIN gave {tag}")
            refresh.apply_rf1(st, rf)
            keys = refresh.rf2_keys(st, count)
            n_li = refresh.rf2_lineitems(st, keys)
            rf2_ms = []
            for column, table, want in (("l_orderkey", "lineitem", n_li),
                                        ("o_orderkey", "orders", len(keys))):
                t1 = time.perf_counter()
                _, _, tags = c.typed_query(f"DELETE FROM {table} WHERE "
                                           + refresh.in_list(column, keys))
                rf2_ms.append((time.perf_counter() - t1) * 1e3)
                check(tags == [f"DELETE {want}"], f"phase 12a: RF2 on {table}"
                      f" gave {tags}, not DELETE {want}")
            refresh.apply_rf2(st, keys)
            after = {}
            for q in refresh.AFTER_REFRESH:
                after[q] = round(run_query(c, q, oracle.run(q, st.tables))[1],
                                 3)
            print(f"phase 12a: RF1 by COPY FROM STDIN: {rf.orders.num_rows} "
                  f"orders in {copy_ms['orders']:.1f} ms, "
                  f"{rf.lineitem.num_rows} lineitems in "
                  f"{copy_ms['lineitem']:.1f} ms (wire; each parsed as one "
                  f"INSERT ... VALUES); RF2: DELETE lineitem ({n_li}) "
                  f"{rf2_ms[0]:.1f} ms, orders ({len(keys)}) "
                  f"{rf2_ms[1]:.1f} ms; Q1, Q3, Q18 == oracle on the edited "
                  f"tables, wire ms {after}")
            out.update(copy_ms=copy_ms, rf2_ms=rf2_ms, after_ms=after,
                       copy_rows=(rf.orders.num_rows, rf.lineitem.num_rows),
                       state=st)

            # COPY TO STDOUT against the host tables
            for name in ("nation", "supplier"):
                t = tables[name]
                t1 = time.perf_counter()
                lines, tag = c.copy_out(f"COPY {name} TO STDOUT")
                ms = (time.perf_counter() - t1) * 1e3
                check(tag == f"COPY {t.num_rows}" and lines == [
                    _copy_text(t, r) for r in range(t.num_rows)],
                    f"phase 12a: COPY {name} TO STDOUT gave {tag} and lines "
                    "that differ from the host table's")
                print(f"phase 12a: COPY {name} TO STDOUT: {len(lines)} lines "
                      f"== the host table's rows, {ms:.1f} ms")

            # a transaction over the wire, and errors
            status = []
            for sql in ("BEGIN", "DELETE FROM nation WHERE n_nationkey = 0",
                        "SELECT COUNT(*) FROM nation"):
                _, rows, _ = c.typed_query(sql)
                status.append(c.last_txn_status)
            inside = rows
            try:
                c.typed_query("SELECT * FROM no_such_table")
                raise CheckFailed("phase 12a: a bad statement gave no "
                                  "ErrorResponse")
            except RuntimeError:
                status.append(c.last_txn_status)
            c.typed_query("ROLLBACK")
            status.append(c.last_txn_status)
            _, rows, _ = c.typed_query("SELECT COUNT(*) FROM nation")
            check(status == [b"T", b"T", b"T", b"E", b"I"]
                  and inside == [(24,)] and rows == [(25,)],
                  f"phase 12a: transaction: ReadyForQuery {status}, nation "
                  f"{inside} inside and {rows} after ROLLBACK")
            try:
                c.typed_query("SELEC 1")
                raise CheckFailed("phase 12a: a syntax error gave no "
                                  "ErrorResponse")
            except RuntimeError as e:
                err = str(e)
            _, rows, _ = c.typed_query("SELECT 21 * 2")
            check(rows == [(42,)] and c.last_txn_status == b"I",
                  "phase 12a: the connection is not usable after an error")
            print(f"phase 12a: BEGIN, DELETE, a bad statement, ROLLBACK: "
                  f"ReadyForQuery {[x.decode() for x in status]}, nation 24 "
                  f"rows inside and 25 after; a syntax error gives an "
                  f"ErrorResponse ({err[:60]!r}) and the connection answers "
                  f"the next query")

            # the catalog, and a cursor over Q18's rows
            _, rows, _ = c.typed_query("SHOW TABLES")
            shown = {r[0] for r in rows}
            check(set(tables) <= shown, f"phase 12a: SHOW TABLES {shown}")
            _, rows, _ = c.typed_query("DESCRIBE lineitem")
            check([r[0] for r in rows]
                  == [f.name for f in tables["lineitem"].fields],
                  f"phase 12a: DESCRIBE lineitem {rows}")
            described_li = rows
            _, rows, _ = c.typed_query(
                "SELECT * FROM information_schema.columns "
                "WHERE table_name = 'orders'")
            check([r[2] for r in rows]
                  == [f.name for f in tables["orders"].fields],
                  f"phase 12a: information_schema.columns {rows}")
            c.typed_query(f"DECLARE c18 CURSOR FOR {queries.QUERIES['Q18']}")
            fetched, pages = [], 0
            while True:
                _, rows, _ = c.typed_query("FETCH 25 FROM c18")
                if not rows:
                    break
                fetched += rows
                pages += 1
            c.typed_query("CLOSE c18")
            _oracle_equal("phase 12a: Q18 through DECLARE and FETCH 25",
                          fetched, oracle.run("Q18", st.tables))
            print(f"phase 12a: SHOW TABLES ({len(shown)}), DESCRIBE lineitem "
                  f"({[tuple(r[1:]) for r in described_li[:2]]} ...), "
                  f"information_schema.columns of orders; DECLARE and "
                  f"{pages} FETCH 25 over Q18: {len(fetched)} rows == oracle")
            c.close()

            # SCRAM-SHA-256 on a second listener over the same Session
            a = PgTestClient("127.0.0.1", srv.ports[1], user=PG_USER,
                             password=PG_PASSWORD)
            _, rows, _ = a.query(queries.QUERIES["Q6"])
            a.close()
            _oracle_equal("phase 12a: Q6 over SCRAM", [(float(rows[0][0]),)],
                          oracle.run("Q6", st.tables))
            try:
                PgTestClient("127.0.0.1", srv.ports[1], user=PG_USER,
                             password="wrong")
                raise CheckFailed("phase 12a: SCRAM took a wrong password")
            except (RuntimeError, ConnectionError):
                pass
            print("phase 12a: a SCRAM-SHA-256 connection answers Q6 == "
                  "oracle; a wrong password is refused")
            launches = collections.Counter()
            for text, recs in records.items():
                q = next((k for k in names if queries.QUERIES[k] == text),
                         "other")
                launches[q] += sum(x["group_agg"] for x in recs)
    finally:
        srv.stop()
    check(not spy.calls, f"phase 12a: {spy.calls} index_add_ calls on the "
          "card")
    if sess.device.type == "cuda":
        for q in TPCH_GROUP_AGG:
            check(launches[q] > 0, f"phase 12a: {q}: group_agg did not launch")
        check(held, "phase 12a: no group_agg call was held against the "
              "plain versions")
    print(f"phase 12a: group_agg launches {dict(launches)}; "
          f"{len(held)} calls held against the plain versions, max abs err "
          f"against float64 summation "
          f"{max((x['max_abs_err'] for x in held), default=0.0):.6g}")
    out["launches"] = dict(launches)
    return out


def _stream_batches(t, rows):
    """`t` (a host table) as batches of `rows` rows on the host, each with
    its own dictionaries: the values present in it, sorted, as a producer
    would encode them."""
    from query_engine_tpu_torch.columnar.batch import padded_capacity
    from query_engine_tpu_torch.columnar.convert import from_numpy_batch

    out = []
    for lo in range(0, t.num_rows, rows):
        n = min(rows, t.num_rows - lo)
        cap = padded_capacity(n)
        valid = np.arange(cap) < n
        planes = []
        for f in t.fields:
            src = t.columns[f.name][lo:lo + n]
            dictionary = None
            if f.name in t.dicts:
                used = np.unique(src)
                dictionary = t.dicts[f.name][used]
                src = np.searchsorted(used, src).astype(np.int32)
            data = np.zeros(cap, dtype=f.data_type.device_dtype)
            data[:n] = src
            planes.append((data, valid, dictionary))
        out.append(from_numpy_batch(t.fields, planes, n, "cpu"))
    return out


def _window_table(t, lo, hi):
    from query_engine_tpu_torch.tpch.data import HostTable

    return HostTable(t.name, t.fields, {k: v[lo:hi]
                                        for k, v in t.columns.items()},
                     t.dicts, hi - lo)


def phase12b(tables, dev):
    """Lineitem streamed in batches of 2^16 rows: tumbling windows of 8
    batches, each window's Q1 against the oracle over its rows; then one
    window over the whole stream."""
    import torch

    from query_engine_tpu_torch.columnar.batch import padded_capacity
    from query_engine_tpu_torch.ops import group_agg
    from query_engine_tpu_torch.streaming.source import MemoryStreamSource
    from query_engine_tpu_torch.streaming.stream import (
        StreamConfig, StreamingQuery,
    )
    from query_engine_tpu_torch.streaming.window import WindowSpec, WindowType
    from query_engine_tpu_torch.tpch import oracle, queries

    li = tables["lineitem"]
    t0 = time.perf_counter()
    batches = _stream_batches(li, STREAM_BATCH)
    build_s = time.perf_counter() - t0
    q1 = queries.QUERIES["Q1"]

    class BatchClock:
        """Time = the batches pulled: a window of `WINDOW_BATCHES` seconds
        closes every WINDOW_BATCHES batches."""
        t = 0.0

        def __call__(self):
            return self.t

    class Source(MemoryStreamSource):
        def __init__(self, batches, clock):
            super().__init__(batches, "lineitem")
            self.clock = clock

        def next_batch(self, timeout=None):
            b = super().next_batch(timeout)
            self.clock.t += b is not None
            return b

    def stream(window):
        clock = BatchClock()
        sq = StreamingQuery(Source(batches, clock), StreamConfig(
            batch_size=STREAM_BATCH, window=window), query=q1,
            table_name="lineitem", clock=clock, device=dev)
        emitted = []
        real = sq._emit_window

        def emit():
            t = sq._dev_table
            s = sq._session
            before = dict(s.executor.pipeline.stats) if s else {}
            rec = {"upload_rows": t.upload_rows, "dict_merges": t.dict_merges,
                   "group_agg": group_agg.launches, "rows": t.num_rows,
                   "batches": clock.t}
            t1 = time.perf_counter()
            real()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            rec["ms"] = (time.perf_counter() - t1) * 1e3
            after = sq._session.executor.pipeline.stats
            rec["stats"] = {k: after[k] - before.get(k, 0) for k in
                            ("compiles", "hits", "captures", "replays")}
            rec["group_agg"] = group_agg.launches - rec["group_agg"]
            if dev.type == "cuda":
                rec["mem"] = (torch.cuda.memory_allocated(),
                              torch.cuda.memory_reserved())
            emitted.append(rec)

        sq._emit_window = emit
        return sq, emitted

    held, spy = [], IndexAddSpy()
    reset_counts()
    with spy.active(), group_agg_held_against_plain(held, spy):
        sq, emitted = stream(WindowSpec(WindowType.TUMBLING,
                                        size_secs=WINDOW_BATCHES))
        t0 = time.perf_counter()
        results = sq.run()
        stream_s = time.perf_counter() - t0
        check(len(results) == len(emitted) == -(-len(batches)
                                                // WINDOW_BATCHES),
              f"phase 12b: {len(results)} windows from {len(batches)} "
              "batches")
        prev_upload, prev_merges, done = 0, 0, 0
        for w, (res, rec) in enumerate(zip(results, emitted)):
            nb = min(WINDOW_BATCHES, len(batches) - done)
            lo = done * STREAM_BATCH
            hi = min(lo + nb * STREAM_BATCH, li.num_rows)
            want = oracle.run("Q1", {"lineitem": _window_table(li, lo, hi)})
            _oracle_equal(f"phase 12b: window {w} (batches {done}-"
                          f"{done + nb - 1})", res.to_pylist(), want)
            uploaded = rec["upload_rows"] - prev_upload
            check(uploaded == hi - lo == rec["rows"],
                  f"phase 12b: window {w}: upload_rows {uploaded}, rows "
                  f"{rec['rows']}, batch rows {hi - lo}")
            mem = ("" if "mem" not in rec else
                   f"; allocated (reserved) {_mib(rec['mem'][0])} "
                   f"({_mib(rec['mem'][1])})")
            print(f"phase 12b: window {w}: {nb} batches, {hi - lo} rows == "
                  f"upload_rows {uploaded}; Q1 == oracle, {rec['ms']:.3f} ms;"
                  f" dict_merges {rec['dict_merges'] - prev_merges}; "
                  f"pipeline {rec['stats']}; group_agg {rec['group_agg']}"
                  f"{mem}")
            prev_upload, prev_merges = rec["upload_rows"], rec["dict_merges"]
            done += nb
        windows = emitted
        t_cap = sq._dev_table.capacity

        # one window over the whole stream: the table grows to 2^23 rows
        sq2, emitted2 = stream(None)
        t0 = time.perf_counter()
        whole = sq2.run()
        whole_s = time.perf_counter() - t0
        table = sq2._dev_table
        _oracle_equal("phase 12b: Q1 over the whole stream", whole[0]
                      .to_pylist(), oracle.run("Q1", tables))
        check(table.upload_rows == li.num_rows and table.capacity
              == padded_capacity(len(batches) * STREAM_BATCH),
              f"phase 12b: whole stream uploaded {table.upload_rows} rows "
              f"into capacity {table.capacity}")
        print(f"phase 12b: one window over all {len(batches)} batches: Q1 == "
              f"phase 7's oracle; the device table grew from "
              f"2^{STREAM_BATCH.bit_length() - 1} to "
              f"2^{table.capacity.bit_length() - 1} rows, "
              f"{_mib(table.nbytes)} on the device; upload_rows "
              f"{table.upload_rows}, upload_bytes {table.upload_bytes}, "
              f"dict_merges {table.dict_merges}, appends {table.appends}; "
              f"the run {whole_s:.2f} s, Q1 {emitted2[0]['ms']:.3f} ms, "
              f"pipeline {emitted2[0]['stats']}, group_agg "
              f"{emitted2[0]['group_agg']}")
    launches = sum(r["group_agg"] for r in windows + emitted2)
    check(not spy.calls, f"phase 12b: {spy.calls} index_add_ calls on the "
          "card")
    if dev.type == "cuda":
        check(launches > 0 and held, f"phase 12b: group_agg launched "
              f"{launches} times, {len(held)} calls held")
    print(f"phase 12b: {len(windows)} tumbling windows of {WINDOW_BATCHES} "
          f"batches ({STREAM_BATCH} rows each, capacity {t_cap}) in "
          f"{stream_s:.2f} s, batches built on the host in {build_s:.2f} s; "
          f"group_agg launches {launches}; {len(held)} calls held against "
          f"the plain versions")
    return {"windows": windows, "whole": emitted2, "launches": launches,
            "held": held, "table_bytes": table.nbytes}


def _rendered_rows(text):
    """The cells of a table as cli/format.py renders it."""
    lines = [ln for ln in text.splitlines() if ln.startswith("| ")]
    return [[c.strip() for c in ln.strip("|").split("|")] for ln in lines[1:]]


def _typed_like(cells, want):
    out = []
    for row, w in zip(cells, want):
        out.append(tuple(None if c == "NULL" else type(v)(c)
                         for c, v in zip(row, w)))
    return out


def phase12c(sess, st, dev):
    """The CLI's query and bench over GENERATE_SERIES(1, 2^23), and a REPL
    over phase 12a's Session."""
    import io

    from query_engine_tpu_torch.cli import main as cli
    from query_engine_tpu_torch.cli.repl import Repl
    from query_engine_tpu_torch.ops import group_agg
    from query_engine_tpu_torch.tpch import oracle, queries

    x = np.arange(1, CLI_ROWS + 1, dtype=np.int64)
    k = x % 16
    want = [(int(g), int((k == g).sum()), int(x[k == g].sum()),
             int(x[k == g].min())) for g in range(16)]
    held, spy = [], IndexAddSpy()
    out = {}
    with spy.active(), group_agg_held_against_plain(held, spy):
        for cmd in ("query", "bench"):
            argv = [cmd, "--device", dev.type, "-s", CLI_QUERY]
            if cmd == "bench":
                argv += ["-n", "5"]
            buf = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            ms = (time.perf_counter() - t0) * 1e3
            text = buf.getvalue()
            check(rc == 0, f"phase 12c: cli {cmd} exited {rc}")
            out[cmd] = {"ms": ms, "group_agg": group_agg.launches}
            if cmd == "query":
                got = _typed_like(_rendered_rows(text), want)
                check(got == want, f"phase 12c: cli query printed {got[:3]}"
                      f" ..., numpy gives {want[:3]} ...")
                print(f"phase 12c: cli query --device {dev.type}: the 16 rows"
                      f" printed == numpy over GENERATE_SERIES(1, {CLI_ROWS})"
                      f"; {ms:.1f} ms for the command (a Session of its own, "
                      f"first run); group_agg {out[cmd]['group_agg']}")
            else:
                stats = {ln.split(":")[0].strip(): ln.split(":")[1].strip()
                         for ln in text.splitlines() if ":" in ln}
                check("Median" in stats and "Throughput" in stats,
                      f"phase 12c: cli bench printed {text!r}")
                out[cmd]["printed"] = stats
                print(f"phase 12c: cli bench --device {dev.type} -n 5: "
                      f"{stats}; group_agg {out[cmd]['group_agg']} (the "
                      f"warm-up's first run and capture)")
        r = Repl(session=sess)
        tables_txt = r.handle(".tables")
        check(set(st.tables) <= set(tables_txt.splitlines()),
              f"phase 12c: .tables gave {tables_txt!r}")
        check(r.handle(".timing") == "timing on", "phase 12c: .timing")
        want_q1 = oracle.run("Q1", st.tables)
        reset_counts()
        text = r.handle(queries.QUERIES["Q1"])
        out["repl"] = {"group_agg": group_agg.launches}
        got = _typed_like(_rendered_rows(text), want_q1)
        _oracle_equal("phase 12c: the REPL's Q1", got, want_q1)
        check("Time:" in text, "phase 12c: the REPL printed no Time: line")
        print(f"phase 12c: REPL over phase 12a's Session: .tables lists the "
              f"{len(st.tables)} tables, .timing on, Q1's rendered rows "
              f"parsed back == oracle on the edited tables; "
              f"{text.splitlines()[-1]}; group_agg "
              f"{out['repl']['group_agg']}")
    check(not spy.calls, f"phase 12c: {spy.calls} index_add_ calls on the "
          "card")
    if dev.type == "cuda":
        check(out["query"]["group_agg"] > 0 and held, "phase 12c: group_agg "
              "did not launch at 2^23 rows")
    out["held"] = held
    out["launches"] = sum(out[k]["group_agg"]
                          for k in ("query", "bench", "repl"))
    return out


def phase12d(sess, st):
    """Flight over the card's Session where pyarrow exists."""
    import importlib.util

    from query_engine_tpu_torch.tpch import oracle, queries

    found = importlib.util.find_spec("pyarrow") is not None
    print(f"phase 12d: pyarrow {'found' if found else 'not found'} on this "
          f"machine")
    if not found:
        print("flight: not run (no pyarrow on this machine)")
        return {"ran": False}
    from query_engine_tpu_torch.columnar.batch import ColumnBatch
    from query_engine_tpu_torch.core.config import FlightConfig
    from query_engine_tpu_torch.flight.client import FlightClient
    from query_engine_tpu_torch.flight.server import FlightServer

    server = FlightServer(FlightConfig(host="127.0.0.1", port=0), sess)
    thread = server.start_background()
    try:
        client = FlightClient(f"grpc://127.0.0.1:{server.port}")
        ms = {}
        for q in ("Q1", "Q3"):
            t0 = time.perf_counter()
            rows = client.execute_sql(queries.QUERIES[q]).to_pylist()
            ms[q] = (time.perf_counter() - t0) * 1e3
            _oracle_equal(f"phase 12d: {q} through do_get", rows,
                          oracle.run(q, st.tables),
                          oracle.FLOAT_SORT_KEYS.get(q, ()))
        put = {"k": list(range(1000)), "v": [i * 0.5 for i in range(1000)]}
        client.upload_table("flight_put", ColumnBatch.from_pydict(put))
        got = client.execute_sql("SELECT COUNT(*), SUM(k), SUM(v) FROM "
                                 "flight_put").to_pylist()
        check(got == [(1000, sum(put["k"]), sum(put["v"]))],
              f"phase 12d: the do_put table read back {got}")
        client.close()
    finally:
        server.shutdown()
        thread.join(30)
    print(f"phase 12d: Flight do_get Q1, Q3 == oracle ({ms} ms); a do_put "
          f"table of 1000 rows read back")
    return {"ran": True, "ms": ms}


def phase12(tables, dev=None):
    """The host services over the card, on a Session of its own over phase
    7's host tables."""
    import gc

    import torch

    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.tpch import data

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sess = Session(device=dev)
    data.register(sess, tables)
    a = phase12a(tables, sess)
    t1 = time.perf_counter()
    b = phase12b(tables, dev)
    t2 = time.perf_counter()
    c = phase12c(sess, a["state"], dev)
    t3 = time.perf_counter()
    d = phase12d(sess, a["state"])
    del sess
    gc.collect()
    print(f"phase 12: 12a {t1 - t_phase:.1f} s, 12b {t2 - t1:.1f} s, 12c "
          f"{t3 - t2:.1f} s, 12d {time.perf_counter() - t3:.1f} s")
    held = a["held"] + b["held"] + c["held"]
    return {"launches": {"12a": sum(a["launches"].values()),
                         "12b": b["launches"], "12c": c["launches"]},
            "max_abs_err": max((x["max_abs_err"] for x in held),
                               default=0.0),
            "flight": d["ran"]}


# phase 13: the chunked aggregate at 2^28 - 17 rows, the host stage walk and
# the Flight transport
N_BIG = (1 << 28) - 17  # 17 pad rows at capacity 2^28
BIG_SEED = 23
SALARY_NULL = 0.01  # share of rows whose salary is NULL
QUERY_C = ("SELECT f.dept, COUNT(f.salary) AS n, AVG(f.salary) AS a, "
           "MIN(f.age) AS lo, MAX(f.salary) AS hi, SUM(f.salary * d.rate) "
           "AS s FROM f JOIN d ON f.dept = d.dept_id WHERE f.age > 25 "
           "GROUP BY f.dept ORDER BY f.dept")
BIG_WARM = 5
STAGE_QUERIES = ("Q1", "Q3", "Q5", "Q6", "Q10", "Q12", "Q14")
STAGE_NO_SHUFFLE = ("Q6",)  # a global aggregate over one table
STAGE_WARM = 2
STAGE_WORKERS = 4


def make_big_tables(dev, n=N_BIG, seed=BIG_SEED):
    """The chunked phase's fact table (age, salary, dept; salary NULL on
    about 1 % of rows) at capacity padded_capacity(n), validity
    arange(cap) < n, and Query A/B's dimension from the same seed. Returns
    the host planes and the two batches."""
    from query_engine_tpu_torch.columnar.batch import padded_capacity
    from query_engine_tpu_torch.columnar.convert import from_numpy_batch
    from query_engine_tpu_torch.core.schema import Field
    from query_engine_tpu_torch.core.types import DataType

    rng = np.random.default_rng(seed)
    cap = padded_capacity(n)
    live = np.arange(cap) < n

    def draw(lo, hi):
        a = rng.integers(lo, hi, cap)
        a[n:] = 0
        return a

    host = {"age": draw(18, 65), "salary": draw(50_000, 150_000),
            "dept": draw(0, N_DIM)}
    host["salary_valid"] = live & (rng.random(cap) >= SALARY_NULL)
    host["bonus"] = rng.integers(0, 1000, N_DIM)
    host["rate"] = rng.integers(128, 384, N_DIM) / 256
    i64, f64 = DataType.int64(), DataType.float64()
    fact = from_numpy_batch(
        [Field("age", i64), Field("salary", i64), Field("dept", i64)],
        [(host["age"], live, None),
         (host["salary"], host["salary_valid"], None),
         (host["dept"], live, None)], n, dev)
    dcap = padded_capacity(N_DIM)
    dvalid = np.arange(dcap) < N_DIM

    def dplanes(arr):
        data = np.zeros(dcap, dtype=arr.dtype)
        data[:N_DIM] = arr
        return data, dvalid, None

    dim = from_numpy_batch(
        [Field("dept_id", i64), Field("bonus", i64), Field("rate", f64)],
        [dplanes(np.arange(N_DIM)), dplanes(host["bonus"]),
         dplanes(host["rate"])], N_DIM, dev)
    return host, fact, dim


def big_oracles(host, n=N_BIG):
    """numpy: Query A's and Query C's rows over the first n rows. Sums of
    integers (and of salary * rate, multiples of 2^-8 below 2^44) are exact
    in float64."""
    age, salary, dept = host["age"][:n], host["salary"][:n], host["dept"][:n]
    m = age > 25
    mv = m & host["salary_valid"][:n]
    dm, dv, sal = dept[m], dept[mv], salary[mv]
    c = np.bincount(dm, minlength=N_DIM)
    nv = np.bincount(dv, minlength=N_DIM)
    s_a = np.bincount(dv, weights=sal + host["bonus"][dv], minlength=N_DIM)
    groups = np.nonzero(c)[0]
    order = groups[np.argsort(-s_a[groups], kind="stable")][:10]
    want_a = [(int(g), int(c[g]), int(s_a[g])) for g in order]
    sum_sal = np.bincount(dv, weights=sal, minlength=N_DIM)
    s_c = np.bincount(dv, weights=sal * host["rate"][dv], minlength=N_DIM)
    lo = np.full(N_DIM, np.iinfo(np.int64).max)
    np.minimum.at(lo, dm, age[m])
    hi = np.full(N_DIM, np.iinfo(np.int64).min)
    np.maximum.at(hi, dv, sal)
    want_c = [(int(g), int(nv[g]), float(sum_sal[g] / nv[g]), int(lo[g]),
               int(hi[g]), float(s_c[g])) for g in groups]
    return want_a, want_c


def _big_form(sess, query, want, tag, exact, chunks):
    """A first and BIG_WARM warm runs of `query`, every one against `want`
    (exactly, or floats to RTOL): the ms of each, the chunked path's stats
    change of each, the group_agg launches over the runs, and the peak
    device memory from a reset just before them. chunks: the chunks a run
    must make (0: it must not run chunked)."""
    import torch

    from query_engine_tpu_torch.tpch import oracle

    ch = sess.executor.chunked.stats
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, runs, err = [], [], 0.0
    for run in range(1 + BIG_WARM):
        before = dict(ch)
        t0 = time.perf_counter()
        rows = sess.sql(query).to_pylist()
        walls.append((time.perf_counter() - t0) * 1e3)
        d = _stats_change(before, ch)
        runs.append(d)
        if exact:
            check(rows == want, f"{tag}: run {run} differs from the numpy "
                  f"oracle: {rows[:3]} against {want[:3]}")
        else:
            err = max(err, _oracle_equal(f"{tag}: run {run}", rows, want))
        if chunks:
            check(d.get("queries") == 1 and d.get("chunks") == chunks,
                  f"{tag}: run {run} did not run in {chunks} chunks: {d}")
            check(run == 0 or not sess.executor.pipeline._graphs or (
                not d.get("captures") and d.get("replays") == chunks),
                  f"{tag}: warm run {run}: the partial program captured "
                  f"again or did not replay once a chunk: {d}")
        else:
            check(not d, f"{tag}: run {run} ran chunked: {d}")
    launches = read_counts()["group_agg"]
    check(launches > 0, f"{tag}: group_agg made no launch")
    out = {"first_ms": walls[0], "ms": statistics.median(walls[1:]),
           "warm_ms": walls[1:], "runs": runs,
           "group_agg": launches, "max_rel_err": err,
           "base_mib": base / 2 ** 20,
           "peak_allocated_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "peak_reserved_mib": torch.cuda.max_memory_reserved() / 2 ** 20}
    print(f"{tag}: {len(rows)} rows == numpy oracle on a first and "
          f"{BIG_WARM} warm runs (max rel err {err:.3g}); first "
          f"{walls[0]:.1f} ms, warm median {out['ms']:.3f} ms (min "
          f"{min(walls[1:]):.3f}, max {max(walls[1:]):.3f}); chunked stats "
          f"first {runs[0]}, warm {runs[1]}; group_agg launches "
          f"{out['group_agg']}; device memory allocated before "
          f"{out['base_mib']:.1f} MiB, peak allocated "
          f"{out['peak_allocated_mib']:.1f} MiB, peak reserved "
          f"{out['peak_reserved_mib']:.1f} MiB")
    return out


def _big_held(sess, forms, n_rows, chunks, spy):
    """The first run of each (tag, query, want, exact) of `forms` on
    `sess`, a Session that has run nothing, with every group_agg call
    outside a capture held against the plain versions (apart from the
    measured runs, so that the plain versions' memory and time stay out of
    their numbers). Each form must make group_agg calls, one of them at
    `n_rows` rows (a chunk's partial program, or the unchunked table), and
    run in `chunks` chunks. Returns the held records and the group_agg
    launches of the runs."""
    held = []
    ch = sess.executor.chunked.stats
    reset_counts()
    with spy.active(), group_agg_held_against_plain(held, spy):
        for tag, query, want, exact in forms:
            first, before = len(held), dict(ch)
            rows = sess.sql(query).to_pylist()
            if exact:
                check(rows == want, f"{tag}: the held run differs from the "
                      f"numpy oracle: {rows[:3]} against {want[:3]}")
            else:
                _oracle_equal(f"{tag}: the held run", rows, want)
            d = _stats_change(before, ch)
            check(d.get("chunks", 0) == chunks, f"{tag}: the held run did not "
                  f"run in {chunks} chunk(s): {d}")
            mine = held[first:]
            shapes = sorted({(c["n"], c["groups"], c["items"]) for c in mine})
            check(any(c["n"] == n_rows for c in mine), f"{tag}: no group_agg "
                  f"call at {n_rows} rows held against the plain versions "
                  f"(held: {shapes})")
            print(f"{tag}: a first run on a Session of its own: "
                  f"{len(mine)} group_agg calls held against the plain "
                  f"versions, (rows, groups, items) {shapes}; max abs err "
                  f"against float64 summation "
                  f"{max((c['max_abs_err'] for c in mine), default=0.0):.3g}")
    return held, read_counts()["group_agg"]


def phase13a(dev=None, n=N_BIG):
    """Query A and Query C at n fact rows, chunked at the defaults, then
    Query A unchunked; each against the numpy oracle."""
    import gc

    import torch

    from query_engine_tpu_torch.engine import chunked
    from query_engine_tpu_torch.engine.session import Session

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    for var in ("QE_CHUNK_ENGAGE", "QE_CHUNK_ROWS"):
        os.environ.pop(var, None)
    t0 = time.perf_counter()
    host, fact, dim = make_big_tables(dev, n)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_a, want_c = big_oracles(host, n)
    oracle_s = time.perf_counter() - t0
    cap, cc = fact.capacity, min(chunked.chunk_rows(), fact.capacity)
    chunks = cap // cc
    check(cap >= chunked.chunk_engage_rows(),
          f"phase 13a: capacity {cap} is below QE_CHUNK_ENGAGE")
    table_mib = sum(c.data.nbytes + c.validity.nbytes
                    for c in fact.columns) / 2 ** 20
    print(f"phase 13a: f {n:,} rows at capacity {cap:,} ({table_mib:.1f} "
          f"MiB on the card), d {N_DIM} rows; built and uploaded in "
          f"{gen_s:.2f} s, oracles {oracle_s:.2f} s; chunks of {cc:,} rows "
          f"({chunks} a query)")
    del host
    gc.collect()
    out = {}

    def session():
        s = Session(device=dev)
        s.register_table("f", fact)
        s.register_table("d", dim)
        return s

    sess = session()
    spy = IndexAddSpy()
    with spy.active():
        out["A chunked"] = _big_form(sess, QUERY, want_a,
                                     "phase 13a: Query A chunked", True,
                                     chunks)
        out["C chunked"] = _big_form(sess, QUERY_C, want_c,
                                     "phase 13a: Query C chunked", False,
                                     chunks)
    busy, wall, names = device_ms(sess, QUERY)
    found = kernel_names(names, "sum_count_")
    check(found, "phase 13a: no group_agg kernel in a profiled warm chunked "
          "Query A")
    check(not kernel_names(names, "indexFunc"), "phase 13a: index_add_ "
          "kernels in a profiled warm chunked Query A")
    print(f"phase 13a: one profiled warm chunked Query A: {busy:.3f} ms of "
          f"kernel time in {wall:.3f} ms wall; group_agg kernels {found}; "
          f"no index_add_ kernel")
    # the staging copy of one chunk alone (device time)
    stager = sess.executor.chunked
    stage_ms = cuda_ms(lambda: stager.stage_chunk(fact, 0, cc, cc))
    row_bytes = sum(c.data.element_size() + c.validity.element_size()
                    for c in fact.columns)
    stage_bound = bound_ms(2 * cc * row_bytes)
    out["staging"] = {"ms": stage_ms, "bound_ms": stage_bound,
                      "bytes": 2 * cc * row_bytes}
    print(f"phase 13a: the staging copy of one chunk ({cc:,} rows, "
          f"{row_bytes} B a row read and written): {stage_ms:.4f} ms "
          f"(CUDA events), bound {stage_bound:.4f} ms, "
          f"{stage_bound / stage_ms:.0%} of it")
    del sess, stager
    gc.collect()
    torch.cuda.empty_cache()
    held, launches = _big_held(session(), [
        ("phase 13a: Query A chunked", QUERY, want_a, True),
        ("phase 13a: Query C chunked", QUERY_C, want_c, False)],
        cc, chunks, spy)
    out["A, C chunked, held"] = {"group_agg": launches}
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["QE_CHUNK_ENGAGE"] = str(2 * cap)
    try:
        sess = session()
        try:
            with spy.active():
                out["A unchunked"] = _big_form(
                    sess, QUERY, want_a, "phase 13a: Query A unchunked",
                    True, 0)
        except torch.cuda.OutOfMemoryError as e:
            # the one failure this phase records: the comparison run's OOM
            out["A unchunked"] = {"oom": str(e).splitlines()[0]}
            print(f"phase 13a: Query A unchunked: out of memory: "
                  f"{out['A unchunked']['oom']}")
        del sess
        gc.collect()
        torch.cuda.empty_cache()
        if "oom" not in out["A unchunked"]:
            more, launches = _big_held(session(), [
                ("phase 13a: Query A unchunked", QUERY, want_a, True)],
                cap, 0, spy)
            held += more
            out["A unchunked, held"] = {"group_agg": launches}
    finally:
        os.environ.pop("QE_CHUNK_ENGAGE")
    check(not spy.calls, f"phase 13a: {spy.calls} index_add_ calls on the "
          "card")
    out["held"] = held
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _stage_stats(dx):
    """The captures made by the stage walk's executors (its local one and
    each worker's) and their host ms."""
    pipes = [dx._local.pipeline] + [
        dx.coordinator.runner(w.worker_id).executor.pipeline
        for w in dx.coordinator.active_workers()]
    return (sum(p.stats["captures"] for p in pipes),
            sum(p.stats["capture_ms"] for p in pipes))


def phase13b(tables, dev=None):
    """TPC-H queries through the host stage walk: a Coordinator with
    STAGE_WORKERS workers, each its own executor on the card, and a
    DistributedExecutor with 4 partitions; every run against the oracle."""
    import torch

    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.parallel.coordinator import Coordinator
    from query_engine_tpu_torch.parallel.dexecutor import DistributedExecutor
    from query_engine_tpu_torch.sql.parser import parse_sql
    from query_engine_tpu_torch.tpch import data, oracle, queries

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    sess = Session(device=dev)
    data.register(sess, tables)
    spy = IndexAddSpy()
    coord = Coordinator(device=dev)
    for i in range(STAGE_WORKERS):
        coord.register_worker(f"worker{i}")
    dx = DistributedExecutor(coord)
    check(dx.planner.default_partitions == 4,
          "phase 13b: the stage walk does not run 4 partitions")
    out = {}
    for q in STAGE_QUERIES:
        plan = sess.optimizer.optimize(
            sess.planner.create_logical_plan(parse_sql(queries.QUERIES[q])))
        dplan = dx.planner.plan(plan)
        check(not dplan.is_local, f"phase 13b: {q}: planned local")
        want = oracle.run(q, tables)
        keys = oracle.FLOAT_SORT_KEYS.get(q, ())
        walls, shuffled, err, held = [], [], 0.0, []
        reset_counts()
        cap0, _ = _stage_stats(dx)
        for run in range(1 + STAGE_WARM):
            rows0 = dx.stats.rows_shuffled
            # the first run's group_agg calls outside a capture (the
            # partial and final aggregates, every partition's) are held
            # against the plain versions; the warm runs are timed bare
            hold = (group_agg_held_against_plain(held, spy) if run == 0
                    else contextlib.nullcontext())
            t0 = time.perf_counter()
            with spy.active(), hold:
                rows = dx.execute(plan, sess.sources).to_pylist()
            walls.append((time.perf_counter() - t0) * 1e3)
            shuffled.append(dx.stats.rows_shuffled - rows0)
            err = max(err, _oracle_equal(f"phase 13b: {q} run {run}", rows,
                                         want, keys))
            check(len(dx.last_stages) > 1, f"phase 13b: {q}: run {run} "
                  f"ran {len(dx.last_stages)} stage(s)")
            check(q in STAGE_NO_SHUFFLE or shuffled[-1] > 0,
                  f"phase 13b: {q}: run {run} shuffled no rows")
            if run == 0:
                cap1, ms1 = _stage_stats(dx)
                first_captures = cap1 - cap0
        cap2, ms2 = _stage_stats(dx)
        warm_captures = (cap2 - cap1) / STAGE_WARM
        warm_capture_ms = (ms2 - ms1) / STAGE_WARM
        stages = [(k, round(ms, 3)) for _, k, ms in dx.last_stages]
        launches = read_counts()["group_agg"]
        check(launches > 0 and held, f"phase 13b: {q}: group_agg launched "
              f"{launches} times, {len(held)} calls held")
        shapes = sorted({(c["n"], c["groups"], c["items"]) for c in held})
        out[q] = {"first_ms": walls[0], "ms": statistics.median(walls[1:]),
                  "stages": len(dx.last_stages),
                  "rows_shuffled": shuffled[0],
                  "group_agg": launches, "held": held,
                  "first_captures": first_captures,
                  "warm_captures": warm_captures,
                  "warm_capture_ms": warm_capture_ms, "max_rel_err": err,
                  "stage_ms": stages}
        print(f"phase 13b: {q}: {len(rows)} rows == numpy oracle on a first "
              f"and {STAGE_WARM} warm runs (max rel err {err:.3g}); first "
              f"{walls[0]:.1f} ms, warm {', '.join(f'{w:.1f}' for w in walls[1:])}"
              f" ms; {len(dx.last_stages)} stages, {shuffled[0]:,} rows "
              f"shuffled a run; first run's captures {first_captures}; "
              f"a warm run's captures {warm_captures:g} taking "
              f"{warm_capture_ms:.1f} ms (host clock, summed over the "
              f"workers' threads); "
              f"group_agg launches {launches}; the first run (its ms "
              f"included) held {len(held)} group_agg calls against the "
              f"plain versions, (rows, groups, items) {shapes}, max abs "
              f"err against float64 summation "
              f"{max(c['max_abs_err'] for c in held):.3g}; last run's stages"
              f" (kind, host ms) {stages}")
    st = dx.stats
    print(f"phase 13b: {STAGE_WORKERS} workers, {st.tasks_executed} tasks, "
          f"{st.task_failures} failures, {st.queries_executed} queries")
    check(st.task_failures == 0, "phase 13b: a task failed")
    check(not spy.calls, f"phase 13b: {spy.calls} index_add_ calls on the "
          "card")
    return out


def phase13c(tables, dev=None):
    """Q1 and Q6 sent by FlightTransport.execute_on_all to two Flight
    servers, each over a Session of its own on the card."""
    import importlib.util

    import torch

    found = importlib.util.find_spec("pyarrow") is not None
    if not found:
        print("phase 13c: Flight transport not run (no pyarrow on this "
              "machine)")
        return {"ran": False}
    from query_engine_tpu_torch.core.config import FlightConfig
    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.flight.server import FlightServer
    from query_engine_tpu_torch.parallel.flight_transport import (
        FlightTransport,
    )
    from query_engine_tpu_torch.tpch import data, oracle, queries

    dev = torch.device("cuda") if dev is None else torch.device(dev)
    servers, threads = [], []
    transport = FlightTransport()
    spy, held = IndexAddSpy(), []
    reset_counts()
    try:
        for i in range(2):
            s = Session(device=dev)
            data.register(s, tables)
            server = FlightServer(FlightConfig(host="127.0.0.1", port=0), s)
            threads.append(server.start_background())
            servers.append(server)
            transport.add_worker(f"worker{i}",
                                 f"grpc://127.0.0.1:{server.port}")
        ms = {}
        for q in ("Q1", "Q6"):
            want = oracle.run(q, tables)
            ms[q] = []
            for run in range(2):  # first (held against plain), warm
                hold = (group_agg_held_against_plain(held, spy) if run == 0
                        else contextlib.nullcontext())
                t0 = time.perf_counter()
                with spy.active(), hold:
                    results = transport.execute_on_all(queries.QUERIES[q])
                ms[q].append((time.perf_counter() - t0) * 1e3)
                check(len(results) == 2, f"phase 13c: {q}: "
                      f"{len(results)} results from 2 workers")
                for r in results:
                    _oracle_equal(f"phase 13c: {q}", r.to_pylist(), want,
                                  oracle.FLOAT_SORT_KEYS.get(q, ()))
    finally:
        for server in servers:
            server.shutdown()
        for t in threads:
            t.join(30)
    launches = read_counts()["group_agg"]
    check(not spy.calls, f"phase 13c: {spy.calls} index_add_ calls on the "
          "card")
    check(launches > 0 and held, f"phase 13c: group_agg launched {launches} "
          f"times, {len(held)} calls held")
    print(f"phase 13c: FlightTransport.execute_on_all to 2 Flight servers: "
          f"Q1 and Q6 == numpy oracle from both; ms (first, warm) {ms}, the "
          f"first runs with {len(held)} group_agg calls held against the "
          f"plain versions (max abs err against float64 summation "
          f"{max(c['max_abs_err'] for c in held):.3g}); group_agg launches "
          f"{launches}")
    return {"ran": True, "ms": ms, "group_agg": launches, "held": held}


def phase13(tables, dev=None):
    """The chunked aggregate at 2^28 - 17 rows (13a), the host stage walk
    at SF1 (13b) and the Flight transport (13c)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    a = phase13a(dev)
    t1 = time.perf_counter()
    b = phase13b(tables, dev)
    t2 = time.perf_counter()
    c = phase13c(tables, dev)
    gc.collect()
    print(f"phase 13: 13a {t1 - t_phase:.1f} s, 13b {t2 - t1:.1f} s, 13c "
          f"{time.perf_counter() - t2:.1f} s")
    launches = {"13a": {k: r["group_agg"] for k, r in a.items()
                        if isinstance(r, dict) and "group_agg" in r},
                "13b": {q: r["group_agg"] for q, r in b.items()},
                "13c": c.get("group_agg", 0)}
    held = a["held"] + [x for r in b.values() for x in r["held"]] \
        + c.get("held", [])
    return {"a": a, "b": b, "c": c, "launches": launches,
            "max_abs_err": max((x["max_abs_err"] for x in held),
                               default=0.0)}


# the mesh building blocks at SF1 (phase 14)
MESH_SHARDS = 4
MESH_WARM = 5
MESH_GROUP_CAP = 128      # (b): (l_returnflag, l_linestatus) has 6 groups
OVERLAP_CHUNKS = 4
RETRY_TRIES = 4           # grow-and-retry attempts before failing
MESH_GROUP_AGG = ("a", "b", "e overlapped", "e sequential")


def _np_splitmix64(x):
    """splitmix64 over uint64 lanes (numpy wraps the products)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _host(t):
    return t.cpu().numpy()


def _shard_live(counts, per):
    """The live slots [s * per, s * per + counts[s]) of a sharded plane."""
    counts = np.minimum(np.asarray(counts).reshape(-1), per)
    return (np.arange(len(counts) * per) % per) < np.repeat(counts, per)


def _with_retry(make, args, factor):
    """The caller's grow-and-retry: run make(factor)(*args), doubling the
    receive factor while the overflow output is non-zero. Returns
    (outputs, retries, factor)."""
    retries = 0
    while True:
        out = make(factor)(*args)
        if int(out[-1].sum()) == 0:
            return out, retries, factor
        retries += 1
        check(retries < RETRY_TRIES, f"overflow after {retries} retries "
              f"(factor {factor})")
        factor *= 2


def _mesh_part(tag, fn, verify, mesh, spy, want_group_agg):
    """One part of phase 14: a first run with every group_agg call held
    against the plain versions, MESH_WARM warm runs (host clock, to the
    end of a synchronize), one profiled warm run; the first and the last
    warm run's results checked by `verify`, which returns what it
    measured."""
    import torch

    from query_engine_tpu_torch.ops import group_agg

    held = []
    reset_counts()
    stats0 = dict(mesh.stats)
    torch.cuda.synchronize()
    with spy.active(), group_agg_held_against_plain(held, spy):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
    launches = read_counts()["group_agg"]
    moved = mesh.stats["bytes_exchanged"] - stats0["bytes_exchanged"]
    collectives = mesh.stats["collectives"] - stats0["collectives"]
    info = verify(res)
    warm = []
    with spy.active():
        for _ in range(MESH_WARM):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
    verify(res)
    del res
    cuda = torch.autograd.DeviceType.CUDA

    def run():
        l0 = group_agg.launches
        fn()
        torch.cuda.synchronize()
        return group_agg.launches - l0

    with spy.active():
        prof, _, prof_launches = profiled(run)
    events = prof.key_averages()
    kernel_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == cuda) / 1e3
    agg_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == cuda
                 and ("sum_count_" in e.key or "float_absmax" in e.key)) / 1e3
    top = sorted((e for e in events if e.device_type == cuda),
                 key=lambda e: -e.self_device_time_total)[:4]
    top = [(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count)
           for e in top]
    if want_group_agg:
        check(launches > 0 and held, f"phase 14 ({tag}): group_agg launched "
              f"{launches} times, {len(held)} calls held")
    err = max((c["max_abs_err"] for c in held), default=0.0)
    rec = {"first_ms": first, "ms": statistics.median(warm),
           "min_ms": min(warm), "max_ms": max(warm),
           "kernel_ms": kernel_ms, "group_agg_kernel_ms": agg_ms,
           "group_agg": launches, "profiled_group_agg": prof_launches,
           "held": len(held), "max_abs_err": err,
           "bytes_exchanged": moved, "collectives": collectives,
           "top_kernels": top, **info}
    shapes = sorted({(c["n"], c["groups"], c["items"]) for c in held})
    extra = ", ".join(f"{k} {v}" for k, v in info.items())
    print(f"phase 14 ({tag}): == numpy oracle on the first and last warm "
          f"run; first {first:.1f} ms, warm median {rec['ms']:.1f} ms "
          f"({rec['min_ms']:.1f}-{rec['max_ms']:.1f}, {MESH_WARM} runs, "
          f"host clock); profiled warm run {kernel_ms:.3f} ms of kernel "
          f"time, group_agg {agg_ms:.3f} ms in {prof_launches} launches; "
          f"first run's group_agg launches {launches}, {len(held)} held "
          f"against the plain versions, (rows, groups, items) {shapes}, "
          f"max abs err against float64 summation {err:.3g}; "
          f"{collectives} collectives moving {moved:,} bytes between "
          f"shards; {extra}; top kernels (name, ms, launches) {top}")
    return rec


def _mesh_oracles(tables):
    """numpy oracles of phase 14 over lineitem and orders."""
    li, orders = tables["lineitem"], tables["orders"]
    c = li.columns
    okey, qty = c["l_orderkey"], c["l_quantity"]
    price, ship = c["l_extendedprice"], c["l_shipdate"]
    n_ord = orders.num_rows
    o = {"li": li, "orders": orders}

    def grouped(g, size):
        cnt = np.bincount(g, minlength=size)
        mn = np.full(size, np.iinfo(np.int64).max)
        mx = np.full(size, np.iinfo(np.int64).min)
        np.minimum.at(mn, g, ship)
        np.maximum.at(mx, g, ship)
        return {"count": cnt,
                "sum": np.bincount(g, weights=qty, minlength=size
                                   ).astype(np.int64),
                "price": np.bincount(g, weights=price, minlength=size),
                "min": mn, "max": mx}

    o["a"] = grouped(okey, n_ord)
    n_ls = len(li.dicts["l_linestatus"])
    o["n_ls"] = n_ls
    o["b"] = grouped(c["l_returnflag"].astype(np.int64) * n_ls
                     + c["l_linestatus"], len(li.dicts["l_returnflag"])
                     * n_ls)
    o_count = np.bincount(orders.columns["o_orderkey"], minlength=n_ord)
    o["o_count"] = o_count
    o["join"] = int(o_count[okey].sum())
    o["sorted_price"] = np.sort(price)
    o["sorted_okey"] = np.sort(okey)
    owner = (_np_splitmix64(okey) % np.uint64(MESH_SHARDS)).astype(np.int64)
    from query_engine_tpu_torch.parallel.overlap import BUCKET_CAP
    flat = owner * BUCKET_CAP + (okey // MESH_SHARDS) % BUCKET_CAP
    o["bucket_sums"] = np.bincount(flat, weights=qty, minlength=MESH_SHARDS
                                   * BUCKET_CAP).astype(np.int64)
    o["bucket_counts"] = np.bincount(flat, minlength=MESH_SHARDS * BUCKET_CAP)
    return o


def _check_grouped(tag, out, want, keys_of, n_keys):
    """A distributed aggregate's outputs (COUNT(*), SUM(l_quantity),
    AVG(l_extendedprice), MIN and MAX(l_shipdate)) against the oracle:
    every group on one shard, each present group once."""
    ng = _host(out[-1])
    per = out[0].shape[0] // MESH_SHARDS
    live = _shard_live(ng, per)
    planes = [_host(p)[live] for p in out[:-1]]
    for v in planes[n_keys: 2 * n_keys]:
        check(v.all(), f"phase 14 ({tag}): a NULL group key")
    g = keys_of(planes[:n_keys])
    check(len(np.unique(g)) == len(g), f"phase 14 ({tag}): a group split "
          "across shards")
    present = np.nonzero(want["count"])[0]
    check(np.array_equal(np.sort(g), present), f"phase 14 ({tag}): "
          f"{len(g)} groups, the oracle {len(present)}")
    cnt, sq, avs, avc, mn, mx = planes[2 * n_keys::2]
    oks = planes[2 * n_keys + 1::2]
    check(all(ok.all() for ok in oks), f"phase 14 ({tag}): a NULL "
          "aggregate")
    check(np.array_equal(cnt, want["count"][g]), f"phase 14 ({tag}): "
          "COUNT(*) differs")
    check(np.array_equal(sq, want["sum"][g]), f"phase 14 ({tag}): "
          "SUM(l_quantity) differs")
    check(np.array_equal(avc, want["count"][g].astype(np.float64)),
          f"phase 14 ({tag}): AVG's count differs")
    check(np.array_equal(mn, want["min"][g]) and np.array_equal(
        mx, want["max"][g]), f"phase 14 ({tag}): MIN/MAX differ")
    avg, want_avg = avs / avc, want["price"][g] / want["count"][g]
    rel = float(np.max(np.abs(avg - want_avg) / np.abs(want_avg)))
    check(rel <= RTOL, f"phase 14 ({tag}): AVG(l_extendedprice) max rel "
          f"err {rel:.3g} above {RTOL}")
    return {"groups": len(g), "avg_max_rel_err": rel}


def phase14(tables, dev=None):
    """The mesh building blocks at SF1 on a virtual mesh of MESH_SHARDS
    shards on one card: the distributed aggregate by l_orderkey (a) and
    by (l_returnflag, l_linestatus) (b), join counts of lineitem and
    orders with salt 1 and 2 (c), the sampled range sort by
    l_extendedprice (d), the overlapped and the sequential
    exchange-aggregate (e), sharded string ingest (f), and one exchange
    that overflows and is retried (g); each against a numpy oracle."""
    import gc

    import torch

    from query_engine_tpu_torch.parallel import spmd
    from query_engine_tpu_torch.parallel.dict_merge import (
        ingest_sharded_strings,
    )
    from query_engine_tpu_torch.parallel.mesh import ShardedTable, make_mesh
    from query_engine_tpu_torch.parallel.overlap import (
        make_overlapped_exchange_aggregate,
        make_sequential_exchange_aggregate,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh([dev] * MESH_SHARDS)
    t0 = time.perf_counter()
    want = _mesh_oracles(tables)
    li, orders = want["li"], want["orders"]
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = ShardedTable(li.to_batch(dev), mesh)
    ost = ShardedTable(orders.to_batch(dev), mesh)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    col = {f.name: i for i, f in enumerate(st.schema)}
    ocol = {f.name: i for i, f in enumerate(ost.schema)}
    rows = _host(st.shard_rows)
    print(f"phase 14: {mesh}; lineitem {li.num_rows:,} rows in shards of "
          f"{st.shard_capacity:,} (live {rows.tolist()}), orders "
          f"{orders.num_rows:,} in shards of {ost.shard_capacity:,}; "
          f"sharded in {shard_s:.2f} s, oracles {oracle_s:.2f} s")
    spy = IndexAddSpy()
    parts = {}

    def d(name):
        return st.datas[col[name]]

    def v(name):
        return st.valids[col[name]]

    aggs = [("count_star", -1), ("sum", 0), ("avg", 1), ("min", 2),
            ("max", 2)]
    agg_args = [d("l_quantity"), d("l_extendedprice"), d("l_shipdate"),
                v("l_quantity"), v("l_extendedprice"), v("l_shipdate")]

    # (a) by l_orderkey, every live row its own potential group
    prog_a = spmd.make_distributed_aggregate(mesh, aggs, 3)
    okey_np = li.columns["l_orderkey"]
    partial = sum(int(np.count_nonzero(np.bincount(
        okey_np[s: s + int(k)]))) if k else 0 for s, k in zip(
        np.concatenate([[0], np.cumsum(rows)[:-1]]), rows))
    parts["a"] = _mesh_part(
        "a: COUNT(*), SUM, AVG, MIN, MAX by l_orderkey",
        lambda: prog_a(d("l_orderkey"), v("l_orderkey"), st.shard_rows,
                       *agg_args),
        lambda out: {**_check_grouped("a", out, want["a"],
                                      lambda k: k[0], 1),
                     "partial_groups_exchanged": partial},
        mesh, spy, True)

    # (b) by (l_returnflag, l_linestatus), group capacity 128
    n_ls = want["n_ls"]
    prog_b = spmd.make_distributed_aggregate(mesh, aggs, 3, n_keys=2,
                                             group_capacity=MESH_GROUP_CAP)
    parts["b"] = _mesh_part(
        f"b: the same by (l_returnflag, l_linestatus), group capacity "
        f"{MESH_GROUP_CAP}",
        lambda: prog_b(d("l_returnflag"), d("l_linestatus"),
                       v("l_returnflag"), v("l_linestatus"), st.shard_rows,
                       *agg_args),
        lambda out: _check_grouped(
            "b", out, want["b"],
            lambda k: k[0].astype(np.int64) * n_ls + k[1], 2),
        mesh, spy, True)

    # (c) lineitem join orders on the order key
    join_args = [d("l_orderkey"), v("l_orderkey"), st.shard_rows,
                 ost.datas[ocol["o_orderkey"]], ost.valids[ocol["o_orderkey"]],
                 ost.shard_rows, d("l_extendedprice"), v("l_extendedprice"),
                 ost.datas[ocol["o_totalprice"]],
                 ost.valids[ocol["o_totalprice"]]]

    def join_check(tag, salt):
        def verify(res):
            out, retries, factor = res
            total = int(out[0].sum())
            left, right = int(out[1].sum()), int(out[2].sum())
            check(total == want["join"], f"phase 14 ({tag}): join size "
                  f"{total:,}, the oracle {want['join']:,}")
            check(left == li.num_rows and right == orders.num_rows * salt,
                  f"phase 14 ({tag}): {left:,} left and {right:,} right "
                  "rows arrived")
            per = out[3].shape[0] // MESH_SHARDS
            counts = _host(out[3])[_shard_live(_host(out[1]), per)]
            check(int(counts.sum()) == total, f"phase 14 ({tag}): per-row "
                  "counts do not add up to the total")
            return {"join_rows": total, "rows_exchanged": left + right,
                    "overflow_retries": retries, "recv_factor": factor}
        return verify

    for salt in (1, 2):
        make = (lambda f, salt=salt: spmd.make_distributed_join_counts(
            mesh, 1, 1, salt=salt, recv_factor=f))
        parts[f"c salt={salt}"] = _mesh_part(
            f"c: lineitem JOIN orders ON l_orderkey = o_orderkey, join "
            f"counts, salt {salt}",
            lambda make=make: _with_retry(make, join_args,
                                          spmd.DEFAULT_RECV_FACTOR),
            join_check(f"c salt={salt}", salt), mesh, spy, False)

    # (d) the sampled range sort by l_extendedprice, l_orderkey carried
    sort_factor = spmd.sort_recv_factor(MESH_SHARDS, 1024 * MESH_SHARDS)

    def sort_check(res):
        out, retries, factor = res
        counts = _host(out[-2])
        check(int(counts.sum()) == li.num_rows, f"phase 14 (d): "
              f"{int(counts.sum()):,} rows after the sort")
        per = out[0].shape[0] // MESH_SHARDS
        keys, payload = _host(out[0]), _host(out[1])
        lows, highs = [], []
        for s in range(MESH_SHARDS):
            k = keys[s * per: s * per + counts[s]]
            check(bool(np.all(k[1:] >= k[:-1])), f"phase 14 (d): shard {s} "
                  "is not sorted")
            if len(k):
                lows.append(k[0])
                highs.append(k[-1])
        check(all(h <= lo for h, lo in zip(highs, lows[1:])),
              "phase 14 (d): a shard's largest key exceeds the next "
              "shard's smallest")
        live = _shard_live(counts, per)
        check(np.array_equal(keys[live], want["sorted_price"]),
              "phase 14 (d): the concatenated keys differ from np.sort")
        check(np.array_equal(np.sort(payload[live]), want["sorted_okey"]),
              "phase 14 (d): the carried l_orderkey rows differ")
        return {"rows_exchanged": int(counts.sum()),
                "rows_by_shard": counts.tolist(),
                "overflow_retries": retries, "recv_factor": factor}

    sort_args = [d("l_extendedprice"), v("l_extendedprice"), st.shard_rows,
                 d("l_orderkey"), v("l_orderkey")]
    parts["d"] = _mesh_part(
        "d: ORDER BY l_extendedprice over the mesh",
        lambda: _with_retry(lambda f: spmd.make_distributed_sort(
            mesh, 1, recv_factor=f), sort_args, sort_factor),
        sort_check, mesh, spy, False)

    # (e) the overlapped and the sequential exchange-aggregate
    ov = make_overlapped_exchange_aggregate(mesh, OVERLAP_CHUNKS)
    exch, agg = make_sequential_exchange_aggregate(mesh)
    e_args = [d("l_orderkey"), v("l_orderkey"), d("l_quantity"),
              st.shard_rows]
    e_out = {}

    def bucket_check(tag):
        def verify(out):
            sums, cnts = _host(out[0]), _host(out[1])
            check(np.array_equal(sums, want["bucket_sums"])
                  and np.array_equal(cnts, want["bucket_counts"]),
                  f"phase 14 ({tag}): bucket sums or counts differ")
            e_out[tag] = (sums, cnts)
            return {"rows_exchanged": int(cnts.sum())}
        return verify

    parts["e overlapped"] = _mesh_part(
        f"e: overlapped exchange-aggregate, {OVERLAP_CHUNKS} chunks",
        lambda: ov(*e_args), bucket_check("e overlapped"), mesh, spy, True)
    parts["e sequential"] = _mesh_part(
        "e: sequential exchange, then aggregate",
        lambda: agg(*exch(*e_args)), bucket_check("e sequential"), mesh,
        spy, True)
    check(all(np.array_equal(a, b) for a, b in zip(
        e_out["e overlapped"], e_out["e sequential"])),
          "phase 14 (e): overlapped and sequential differ")

    # (f) sharded string ingest of l_shipmode
    modes = li.dicts["l_shipmode"][li.columns["l_shipmode"]]
    shard_vals = [a.tolist() for a in np.array_split(modes, MESH_SHARDS)]
    global_vals = np.unique(modes)

    def ingest_check(res):
        codes, valid, nrows, gdict = res
        check(list(gdict.values) == list(global_vals), "phase 14 (f): the "
              "merged dictionary differs from the sorted global values")
        check(nrows.tolist() == [len(x) for x in shard_vals],
              "phase 14 (f): rows per shard differ")
        live = _shard_live(nrows, st.shard_capacity)
        want_codes = np.searchsorted(global_vals, modes)
        check(np.array_equal(_host(codes)[live], want_codes)
              and bool(_host(valid)[live].all())
              and not bool(_host(valid)[~live].any()),
              "phase 14 (f): codes differ from the global sorted codes")
        return {"values": len(gdict)}

    parts["f"] = _mesh_part(
        "f: ingest_sharded_strings of l_shipmode",
        lambda: ingest_sharded_strings(mesh, shard_vals, st.shard_capacity),
        ingest_check, mesh, spy, False)

    # (g) a hot key overflows the default bound; grow and retry
    air = li.code("l_shipmode", "AIR")
    hot_key = int(orders.columns["o_orderkey"][0])
    skew = torch.where(d("l_shipmode") == air, hot_key, d("l_orderkey"))
    skew_np = np.where(li.columns["l_shipmode"] == air, hot_key, okey_np)
    skew_join = int(want["o_count"][skew_np].sum())
    g_args = [skew] + join_args[1:]
    attempts = []
    factor = spmd.DEFAULT_RECV_FACTOR
    t0 = time.perf_counter()
    with spy.active():
        while True:
            t1 = time.perf_counter()
            out = spmd.make_distributed_join_counts(
                mesh, 1, 1, recv_factor=factor)(*g_args)
            ovf = int(out[-1].sum())
            attempts.append({"recv_factor": factor, "overflow": ovf,
                             "ms": (time.perf_counter() - t1) * 1e3})
            if ovf == 0:
                break
            check(len(attempts) < RETRY_TRIES, "phase 14 (g): overflow "
                  f"after {len(attempts)} attempts")
            factor *= 2
    g_total = int(out[0].sum())
    check(attempts[0]["overflow"] > 0, "phase 14 (g): the skewed exchange "
          "did not overflow at the default factor")
    check(g_total == skew_join, f"phase 14 (g): join size {g_total:,} after "
          f"the retry, the oracle {skew_join:,}")
    parts["g"] = {"attempts": attempts, "join_rows": g_total,
                  "ms": (time.perf_counter() - t0) * 1e3,
                  "hot_rows": int((skew_np == hot_key).sum())}
    print(f"phase 14 (g): {parts['g']['hot_rows']:,} rows on one key: "
          f"overflow {attempts[0]['overflow']:,} at factor "
          f"{attempts[0]['recv_factor']}, exact after "
          f"{len(attempts) - 1} grow-and-retry ({g_total:,} rows == "
          f"oracle); attempts {attempts}")
    check(not spy.calls, f"phase 14: {spy.calls} index_add_ calls on the "
          "card")
    for tag in MESH_GROUP_AGG:
        check(parts[tag]["group_agg"] > 0, f"phase 14 ({tag}): no group_agg "
              "launch")
    del st, ost, skew
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"phase 14: {seconds:.1f} s; mesh stats {mesh.stats}")
    timed = {k: r for k, r in parts.items() if "group_agg" in r}
    return {"parts": parts, "seconds": seconds,
            "launches": {k: r["group_agg"] for k, r in timed.items()},
            "max_abs_err": max(r["max_abs_err"] for r in timed.values())}


# ---- phase 15: count->emit programs, outer joins, FD pruning --------------
COUNT_EMIT_WARM = 5
# the stats phase 15 prints per query (first run and per warm run)
CE_STATS = ("joins_counted", "joins_inlined", "joins_demoted",
            "join_sorts_reused", "group_sorts_reused", "fd_pruned_keys",
            "compiles", "hits", "captures", "replays")


def phase15(tables):
    """The joins and aggregates the compiled pipeline sizes at run time
    (`tpch/count_emit.py`: J1 a bounded-duplication emit, J2 and J3
    counted joins on direct ranks and on the sorted path, J4a-c outer
    joins with and without a residual, G1a-b group-space counting, Q3 and
    Q10 with their GROUP BY keys pruned) at SF1 on a Session of its own,
    each first and COUNT_EMIT_WARM times warm against its numpy oracle."""
    import gc

    import torch

    from query_engine_tpu_torch.columnar.batch import padded_capacity
    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.tpch import count_emit as CE
    from query_engine_tpu_torch.tpch import data

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sess = Session(device="cuda")
    data.register(sess, tables)
    torch.cuda.synchronize()
    pipe = sess.executor.pipeline
    timing = ("leaf_ms", "capture_ms")
    out, held = {}, {}
    for q, text in CE.QUERIES.items():
        t0 = time.perf_counter()
        want = CE.run(q, tables)
        oracle_s = time.perf_counter() - t0
        st0, syncs0 = dict(pipe.stats), sess.executor.host_syncs
        kinds0 = collections.Counter(pipe.leaf_kinds)
        keys0 = set(pipe._cache)
        held[q] = []
        spy = IndexAddSpy()
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held[q], spy):
            t0 = time.perf_counter()
            rows = sess.sql(text).to_pylist()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()["group_agg"]
        first = _stats_change(st0, pipe.stats, timing)
        first_syncs = sess.executor.host_syncs - syncs0
        try:
            err = CE.compare(q, rows, want)
        except AssertionError as e:
            raise CheckFailed(f"phase 15: {q} differs from the numpy "
                              f"oracle: {e}") from None
        check(rows, f"phase 15: {q} returned no rows")
        walls = []
        st1, syncs1 = dict(pipe.stats), sess.executor.host_syncs
        for _ in range(COUNT_EMIT_WARM):
            t0 = time.perf_counter()
            with spy.active():
                again = sess.sql(text).to_pylist()
            walls.append((time.perf_counter() - t0) * 1e3)
            try:
                CE.compare(q, again, want)
            except AssertionError as e:
                raise CheckFailed(f"phase 15: {q}: a warm run differs from "
                                  f"the oracle: {e}") from None
        warm = {k: v / COUNT_EMIT_WARM for k, v in
                _stats_change(st1, pipe.stats, timing).items()}
        syncs = (sess.executor.host_syncs - syncs1) / COUNT_EMIT_WARM
        leaves = dict(pipe.leaf_kinds - kinds0)
        busy, wall, names = device_ms(sess, text)
        # each captured program's kernel time by operator: the count
        # program's, then the emit program's
        programs = {}
        for key in sorted(set(pipe._cache) - keys0,
                          key=lambda k: k[-1] != "count"):
            entry = pipe._cache[key]
            if entry.graph is not None:
                kind = "count" if entry.counts else "emit"
                programs[kind] = profile_program(
                    sess, f"phase 15: {q}: {kind} program", entry)
        r = out[q] = {
            "rows": len(rows), "max_rel_err": err, "first_ms": first_ms,
            "ms": statistics.median(walls), "min_ms": min(walls),
            "max_ms": max(walls), "first_syncs": first_syncs,
            "syncs": syncs, "first": {k: first.get(k, 0) for k in CE_STATS},
            "warm": {k: warm.get(k, 0) for k in CE_STATS},
            "eager_leaves": leaves, "group_agg": launches,
            "group_agg_slots": sorted({c["groups"] for c in held[q]}),
            "device_ms": busy, "profiled_wall_ms": wall,
            "program_ms": {k: v[0] for k, v in programs.items()},
            "by_operator_ms": {k: v[1] for k, v in programs.items()},
            "group_agg_kernels": kernel_names(names, "sum_count_",
                                              "float_absmax"),
            "index_add_kernels": kernel_names(names, "indexFunc"),
            "index_add_calls": spy.calls}
        print(f"phase 15: {q}: {len(rows)} rows == numpy oracle (max rel err "
              f"{err:.3g}, oracle {oracle_s:.2f} s); first run "
              f"{first_ms:.1f} ms, {first_syncs} syncs, stats {r['first']}; "
              f"warm {r['ms']:.3f} ms/query median of {COUNT_EMIT_WARM} "
              f"({r['min_ms']:.3f}-{r['max_ms']:.3f}), {syncs:g} host "
              f"syncs/query, stats per warm query {r['warm']}; eager leaves "
              f"{leaves}; group_agg launches {launches} at slots "
              f"{r['group_agg_slots']}; one profiled warm run: {busy:.3f} ms "
              f"of kernel time in {wall:.3f} ms wall; index_add_ calls "
              f"{spy.calls}")
        for c in held[q]:
            print(f"phase 15: {q}: group_agg == plain on the same tensors: "
                  f"n={c['n']} G={c['groups']} {c['items']} items "
                  f"({c['float_items']} float, {c['count_items']} count "
                  f"only); max abs err against float64 summation "
                  f"{c['max_abs_err']:.6g}")
        check(not r["index_add_kernels"] and not spy.calls,
              f"phase 15: {q}: index_add_ on the card ({spy.calls} calls, "
              f"kernels {r['index_add_kernels']})")
        check(not launches or held[q], f"phase 15: {q}: no group_agg call of "
              "its first run was held against the plain version")
        check(not first.get("fallbacks") and (first.get("compiles")
                                               or first.get("hits")),
              f"phase 15: {q} did not run in the compiled pipeline: {first}")
        check(not first.get("joins_demoted"),
              f"phase 15: {q}: a join was demoted: {first}")
        if q in CE.JOINS:
            check("HashJoin" not in leaves, f"phase 15: {q}: its join ran as "
                  f"an eager leaf: {leaves}")
        if q in CE.COUNTED:
            check(first.get("joins_counted", 0) >= 1, f"phase 15: {q}: no "
                  f"count program sized it: {first}")
        if q in CE.SORT_REUSED:
            check(first.get("join_sorts_reused", 0) >= 1, f"phase 15: {q}: "
                  f"the emit program did not reuse the count's sort: {first}")
        if q in CE.GROUPING_REUSED:
            bucket = padded_capacity(len(rows))
            check(first.get("group_sorts_reused", 0) >= 1
                  and launches > 0 and r["group_agg_slots"] == [bucket],
                  f"phase 15: {q}: not aggregated through group_agg at "
                  f"padded(ng) = {bucket} slots with the count's grouping: "
                  f"slots {r['group_agg_slots']}, {first}")
        if not leaves:
            check(not r["warm"]["captures"] and not r["warm"]["compiles"],
                  f"phase 15: {q}: a warm run compiled or captured anew: "
                  f"{r['warm']}")
    check(out["J1"]["first"]["joins_counted"] == 0,
          f"phase 15: J1's bounded-duplication join was counted: "
          f"{out['J1']['first']}")
    for q in CE.FD_QUERIES:
        print(f"phase 15: {q}: GROUP BY keys pruned as dependent "
              f"{out[q]['first']['fd_pruned_keys']} (first run's programs)")
    check(out["Q3"]["first"]["fd_pruned_keys"] >= 2,
          "phase 15: Q3's o_orderdate and o_shippriority were not pruned")
    del sess, pipe
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    total = sum(r["ms"] for r in out.values())
    print(f"phase 15: {seconds:.1f} s; the {len(out)} queries "
          f"{total:.1f} ms in all (sum of the warm medians)")
    errs = [c["max_abs_err"] for calls in held.values() for c in calls]
    return {"queries": out, "seconds": seconds,
            "launches": {q: r["group_agg"] for q, r in out.items()},
            "max_abs_err": max(errs, default=0.0)}


MESH_TPCH_WARM = 2        # phase 16a: warm runs a query (median)
MESH_MS_KEYS = ("compiles", "hits", "fallbacks", "exchanges",
                "overflow_retries", "joins_counted", "eager_leaves",
                "eager_rows", "agg_partial_final")
MESH_SERVED = ("Q1", "Q6", "Q14")      # 16c over pgwire
MESH_STAGED = ("Q1", "Q6")             # 16c through DistributedExecutor
_CARD = []


def card_label():
    """The card's name and power limit as nvidia-smi gives them (read
    once)."""
    if not _CARD:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
        _CARD.append(smi.stdout.strip().splitlines()[0])
    return _CARD[0]


def _mesh_run(sess, text, spy, held=None):
    """One query through a mesh Session: (rows, ms to the end of a
    synchronize, mesh stats change, rows and bytes exchanged, group_agg
    launches); its group_agg calls held against the plain versions when
    `held` is a list."""
    import torch

    mp = sess.mesh_pipeline
    mesh = mp.mesh
    st0 = dict(mp.stats)
    rows0, bytes0 = mesh.rows_exchanged(), mesh.stats["bytes_exchanged"]
    hold = (group_agg_held_against_plain(held, spy) if held is not None
            else contextlib.nullcontext())
    reset_counts()
    torch.cuda.synchronize()
    with spy.active(), hold:
        t0 = time.perf_counter()
        rows = sess.sql(text).to_pylist()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()["group_agg"]
    delta = {k: mp.stats[k] - st0[k] for k in MESH_MS_KEYS}
    moved = (mesh.rows_exchanged() - rows0,
             mesh.stats["bytes_exchanged"] - bytes0)
    return rows, ms, delta, moved, launches


def phase16a(tables, card, spy):
    """The 22 TPC-H queries at SF1 through a 4-shard virtual mesh on the
    card, each against the numpy oracle."""
    import torch

    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.ops import group_agg
    from query_engine_tpu_torch.parallel.mesh import make_mesh
    from query_engine_tpu_torch.tpch import data, oracle, queries

    mesh = make_mesh(["cuda:0"] * MESH_SHARDS)
    sess = Session(device="cuda", mesh=mesh)
    data.register(sess, tables)
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out, held = {}, {}
    for q, text in queries.QUERIES.items():
        want = oracle.run(q, tables)
        keys = oracle.FLOAT_SORT_KEYS.get(q, ())
        held[q] = []
        rows, first_ms, delta, (rx, bx), launches = _mesh_run(
            sess, text, spy, held[q])
        err = _oracle_equal(f"phase 16a: {q} through the mesh", rows, want,
                            keys)
        check(len(rows) > 0 or q in TPCH_NO_ROWS_AT_SF1,
              f"phase 16a: {q} returned no rows")
        lowered = delta["compiles"] + delta["hits"] > 0
        walls = []
        for _ in range(MESH_TPCH_WARM):
            again, ms, _, _, _ = _mesh_run(sess, text, spy)
            walls.append(ms)
        _oracle_equal(f"phase 16a: {q}: a warm run", again, want, keys)

        def run():
            l0 = group_agg.launches
            sess.sql(text).to_pylist()
            torch.cuda.synchronize()
            return group_agg.launches - l0

        with spy.active():
            prof, tries, prof_launches = profiled(run)
        events = prof.key_averages()
        kernel_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == cuda) / 1e3
        agg_ms = sum(e.self_device_time_total for e in events
                     if e.device_type == cuda and (
                         "sum_count_" in e.key or "float_absmax" in e.key)
                     ) / 1e3
        check(not launches or held[q], f"phase 16a: {q}: no group_agg call "
              "of its first run was held against the plain versions")
        r = out[q] = {
            "rows": len(rows), "lowered": lowered, "max_rel_err": err,
            "first_ms": first_ms, "ms": statistics.median(walls),
            "min_ms": min(walls), "max_ms": max(walls), "stats": delta,
            "rows_exchanged": rx, "bytes_exchanged": bx,
            "group_agg": launches, "held": len(held[q]),
            "profiled_group_agg": prof_launches, "kernel_ms": kernel_ms,
            "group_agg_kernel_ms": agg_ms}
        print(f"phase 16a: {q}: {len(rows)} rows == numpy oracle (max rel "
              f"err {err:.3g}); {'lowered to the mesh' if lowered else 'fell back to one device'}; "
              f"stats {delta}; {rx:,} rows and {bx:,} bytes exchanged; first "
              f"run {first_ms:.1f} ms, warm {r['ms']:.3f} ms median of "
              f"{MESH_TPCH_WARM} ({r['min_ms']:.3f}-{r['max_ms']:.3f}, host "
              f"clock to a synchronize); first run's group_agg launches "
              f"{launches}, {len(held[q])} held against the plain versions; "
              f"one profiled warm run: {kernel_ms:.3f} ms of kernel time, "
              f"group_agg {agg_ms:.3f} ms in {prof_launches} launches "
              f"({tries} profile tries) [{card}]")
    lowered = [q for q, r in out.items() if r["lowered"]]
    print(f"phase 16a: {len(lowered)} of {len(out)} queries lowered to the "
          f"mesh ({', '.join(q for q in out if q not in lowered) or 'none'} "
          f"fell back); stats {sess.mesh_pipeline.stats}")
    check("Q1" in lowered and out["Q1"]["group_agg"] > 0,
          f"phase 16a: Q1 did not run on the mesh through group_agg: "
          f"{out['Q1']}")
    check(not spy.calls, f"phase 16a: {spy.calls} index_add_ calls on the "
          "card")
    del sess
    return out, held


def phase16b(tables, card, spy):
    """Phase 15's J2 (no bounded side) through the mesh: the mesh's
    count program, then the emit program."""
    import torch

    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.parallel.mesh import make_mesh
    from query_engine_tpu_torch.tpch import count_emit as CE
    from query_engine_tpu_torch.tpch import data

    sess = Session(device="cuda", mesh=make_mesh(["cuda:0"] * MESH_SHARDS))
    data.register(sess, tables)
    torch.cuda.synchronize()
    want = CE.run("J2", tables)
    held = []
    rows, first_ms, delta, (rx, bx), launches = _mesh_run(
        sess, CE.QUERIES["J2"], spy, held)
    try:
        err = CE.compare("J2", rows, want)
    except AssertionError as e:
        raise CheckFailed(f"phase 16b: J2 through the mesh differs from the "
                          f"numpy oracle: {e}") from None
    check(delta["joins_counted"] >= 1 and delta["fallbacks"] == 0,
          f"phase 16b: J2 was not sized by the mesh's count program: {delta}")
    walls = []
    for _ in range(MESH_TPCH_WARM):
        again, ms, wdelta, _, _ = _mesh_run(sess, CE.QUERIES["J2"], spy)
        walls.append(ms)
    CE.compare("J2", again, want)
    print(f"phase 16b: J2: {len(rows)} rows == numpy oracle (max rel err "
          f"{err:.3g}); stats {delta}, a warm run's {wdelta}; {rx:,} rows and "
          f"{bx:,} bytes exchanged; first run {first_ms:.1f} ms, warm "
          f"{statistics.median(walls):.3f} ms median of {MESH_TPCH_WARM}; "
          f"group_agg launches {launches}, {len(held)} held [{card}]")
    return {"rows": len(rows), "stats": delta, "first_ms": first_ms,
            "ms": statistics.median(walls), "group_agg": launches,
            "held": held, "max_rel_err": err}


def phase16c(tables, card, spy):
    """A pgwire server over a Session that QE_MESH_DEVICES=4 makes (4
    virtual shards of the one card), and DistributedExecutor(mesh=...)."""
    import torch

    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.parallel.coordinator import Coordinator
    from query_engine_tpu_torch.parallel.dexecutor import DistributedExecutor
    from query_engine_tpu_torch.parallel.mesh import make_mesh
    from query_engine_tpu_torch.pgwire import server as pg
    from query_engine_tpu_torch.sql.parser import parse_sql
    from query_engine_tpu_torch.tpch import data, oracle, queries
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_pg_wire import ServerThread, WireClient

    saved = os.environ.get("QE_MESH_DEVICES")
    os.environ["QE_MESH_DEVICES"] = str(MESH_SHARDS)
    try:
        sess = Session(device="cuda")
    finally:
        if saved is None:
            del os.environ["QE_MESH_DEVICES"]
        else:
            os.environ["QE_MESH_DEVICES"] = saved
    mp = sess.mesh_pipeline
    check(mp is not None and mp.n == MESH_SHARDS
          and all(d.type == "cuda" for d in mp.mesh.devices),
          f"phase 16c: QE_MESH_DEVICES={MESH_SHARDS} made no mesh of the "
          f"card: {None if mp is None else mp.mesh}")
    data.register(sess, tables)
    torch.cuda.synchronize()
    out = {"served": {}, "staged": {}}
    held = []
    launches = 0
    srv = ServerThread(pg.PgServer(sess, "127.0.0.1", 0)).start()
    try:
        c = WireClient("127.0.0.1", srv.port)
        for q in MESH_SERVED:
            st0 = dict(mp.stats)
            reset_counts()
            with spy.active(), group_agg_held_against_plain(held, spy):
                t0 = time.perf_counter()
                _, rows, tags = c.typed_query(queries.QUERIES[q])
                ms = (time.perf_counter() - t0) * 1e3
            launches += read_counts()["group_agg"]
            err = _oracle_equal(f"phase 16c: {q} over pgwire", rows,
                                oracle.run(q, tables),
                                oracle.FLOAT_SORT_KEYS.get(q, ()))
            delta = {k: mp.stats[k] - st0[k] for k in MESH_MS_KEYS}
            check(delta["compiles"] + delta["hits"] > 0,
                  f"phase 16c: {q} over pgwire did not run on the mesh: "
                  f"{delta}")
            out["served"][q] = {"rows": len(rows), "wire_ms": ms,
                                "stats": delta}
            print(f"phase 16c: {q} over pgwire (Session by QE_MESH_DEVICES="
                  f"{MESH_SHARDS}): {len(rows)} rows == numpy oracle (max rel "
                  f"err {err:.3g}), {tags}; first run's wire {ms:.1f} ms; "
                  f"stats {delta} [{card}]")
        c.close()
    finally:
        srv.stop()
    coord = Coordinator(device="cuda")
    for i in range(STAGE_WORKERS):
        coord.register_worker(f"worker{i}")
    dx = DistributedExecutor(coord, mesh=make_mesh(["cuda:0"] * MESH_SHARDS))
    for q in MESH_STAGED:
        plan = sess.optimizer.optimize(
            sess.planner.create_logical_plan(parse_sql(queries.QUERIES[q])))
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held, spy):
            t0 = time.perf_counter()
            rows = dx.execute(plan, sess.sources).to_pylist()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches += read_counts()["group_agg"]
        err = _oracle_equal(f"phase 16c: {q} through DistributedExecutor"
                            "(mesh=...)", rows, oracle.run(q, tables),
                            oracle.FLOAT_SORT_KEYS.get(q, ()))
        st = dx._mesh_pipeline.stats
        check(not dx.last_stages and st["compiles"] + st["hits"] > 0,
              f"phase 16c: {q}: DistributedExecutor(mesh=...) took the stage "
              f"walk: {dx.last_stages}, {st}")
        out["staged"][q] = {"rows": len(rows), "ms": ms}
        print(f"phase 16c: {q} through DistributedExecutor(mesh=4 shards): "
              f"{len(rows)} rows == numpy oracle (max rel err {err:.3g}); "
              f"first run {ms:.1f} ms [{card}]")
    print(f"phase 16c: the mesh executor's stats {dx._mesh_pipeline.stats}")
    out["group_agg"] = launches
    out["held"] = held
    return out


def phase16(tables):
    """The mesh pipeline at SF1 on 4 virtual shards of the card: the 22
    TPC-H queries (16a), a counted join (16b), pgwire over a
    QE_MESH_DEVICES Session and DistributedExecutor(mesh=...) (16c)."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_label()
    spy = IndexAddSpy()
    tpch, held_a = phase16a(tables, card, spy)
    gc.collect()
    torch.cuda.empty_cache()
    j2 = phase16b(tables, card, spy)
    gc.collect()
    torch.cuda.empty_cache()
    served = phase16c(tables, card, spy)
    check(not spy.calls, f"phase 16: {spy.calls} index_add_ calls on the "
          "card")
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    total = sum(r["ms"] for r in tpch.values())
    print(f"phase 16: {seconds:.1f} s; the 22 queries {total:.1f} ms in all "
          f"(sum of the warm medians) [{card}]")
    errs = [c["max_abs_err"] for calls in held_a.values() for c in calls]
    errs += [c["max_abs_err"] for c in j2["held"] + served["held"]]
    launches = {q: r["group_agg"] for q, r in tpch.items()}
    launches["J2"] = j2["group_agg"]
    launches["16c"] = served["group_agg"]
    return {"queries": tpch, "j2": j2, "seconds": seconds,
            "launches": launches, "max_abs_err": max(errs, default=0.0)}


HJ_SEED = 10
HJ_RUNS = 15  # timed graph replays a route (median)
HJ_PLAIN_RUNS = 3  # timed eager runs of the plain versions (median)
HJ_SOURCE = "query_engine_tpu_torch/csrc/hash_join.cu"
HJ_REPLACES = {"hash_build": "query_engine_tpu/ops/hash_join.py:75",
               "hash_probe": "query_engine_tpu/ops/hash_join.py:118"}


# the hash join's kernels by their mangled template names (int: IiE, long
# long: IxE)
HJ_FUNCTIONS = {"build fill int32": "hash_fill_kernelIiE",
                "build fill int64": "hash_fill_kernelIxE",
                "build int32": "hash_build_kernelIiE",
                "build int64": "hash_build_kernelIxE",
                "probe int32": "hash_probe_kernelIiE",
                "probe int64": "hash_probe_kernelIxE"}
# the SASS that shows the design: a probe step is one vector load of the
# packed slot (128 bits for int64 keys, 64 for int32), a build claim one CAS
# (of the whole 64-bit slot for int32 keys, of the row word for int64), the
# fill one store a slot
HJ_SASS = {"probe int64": r"LDG\.E\S*\.128", "probe int32": r"LDG\.E\S*\.64",
           "build int32": r"ATOMG\S*\.CAS\S*\.64",
           "build int64": r"ATOMG\S*\.CAS",
           "build fill int32": r"STG\.E\S*\.64",
           "build fill int64": r"STG\.E\S*\.128"}


def _ptxas_by_function(log):
    """{mangled name: "N registers, S bytes spill stores, L bytes spill
    loads"} from nvcc's -Xptxas -v output."""
    out, name, spills = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), ""
        elif name and "spill stores" in line:
            spills = ", ".join(x.strip() for x in line.split(",")[1:])
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[name] = f"{regs} registers, {spills}"
    return out


def _sass_by_function(so_path):
    """{mangled name: [SASS opcode, ...]} from cuobjdump -sass of the
    kernel library, or None where the toolkit has no cuobjdump."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or (
        os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else None)
    if not tool or not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                       text=True, timeout=120)
    check(r.returncode == 0, f"cuobjdump failed: {r.stderr.strip()[:500]}")
    out, name = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if name and m:
            out[name].append(m.group(1))
    return out


def hash_join_design(card):
    """Phase 17's evidence of the kernels' design: ptxas's registers and
    spills for each hash kernel, and, where cuobjdump exists, each one's
    global loads and atomics in SASS, which must hold the packed slot's one
    vector load a probe step and one CAS a build claim."""
    from query_engine_tpu_torch.ops._build import load_library

    built = load_library()
    ptxas = _ptxas_by_function(built.log)
    sass = _sass_by_function(built.path)
    out = {}
    for label, tag in HJ_FUNCTIONS.items():
        rec = {}
        regs = [v for k, v in ptxas.items() if tag in k]
        rec["ptxas"] = regs[0] if regs else (
            "not printed (library loaded from an earlier build)"
            if not built.log else "not found")
        if sass is not None:
            ops = [op for k, v in sass.items() if tag in k for op in v]
            mem = collections.Counter(
                op for op in ops if op.startswith(("LDG", "STG", "ATOM",
                                                   "RED")))
            rec["sass"] = dict(sorted(mem.items()))
            rec["design_ops"] = sum(
                n for op, n in mem.items() if re.fullmatch(
                    HJ_SASS[label] + r"\S*", op))
        print(f"phase 17 design, {label}: ptxas {rec['ptxas']}; SASS "
              f"{rec.get('sass', 'not read (no cuobjdump)')} [{card}]")
        out[label] = rec
    for label, rec in out.items():
        if "design_ops" in rec:
            check(rec["design_ops"] > 0,
                  f"phase 17: no {HJ_SASS[label]} in the {label} kernel's "
                  f"SASS: {rec['sass']}")
    return out


def _unique_keys(rng, n, lo, hi):
    """n distinct int64 keys from [lo, hi), in random order."""
    keys = np.unique(rng.integers(lo, hi, n + n // 8 + 64))
    check(keys.shape[0] >= n, "phase 17: too few distinct keys drawn")
    rng.shuffle(keys)
    return keys[:n]


def hash_join_cases():
    """name -> (build keys, build ok, probe keys, probe ok, table size) as
    numpy, for phase 17's cases (a)-(c)."""
    from query_engine_tpu_torch.ops.hash_join import table_size_for

    rng = np.random.default_rng(HJ_SEED)
    out = {}
    # (a) docs/TPU_DESIGN.md #10: 8M probe x 1M unique build, 48-bit keys
    nb, npr = 1 << 20, 1 << 23
    bkeys = _unique_keys(rng, nb, 0, 1 << 48)
    bok = np.arange(nb) < nb - 3
    live = bkeys[bok]
    hits = rng.choice(live, npr)
    missing = rng.random(npr) < 0.10
    pkeys = np.where(missing, rng.integers(0, 1 << 48, npr), hits)
    pok = (np.arange(npr) < npr - 17) & (rng.random(npr) >= 0.02)
    out["a"] = (bkeys, bok, pkeys, pok, table_size_for(nb))
    # (b) bench.py's _build_args: int32 probe keys U[0, 2^20) over 2^24 -
    # 17 rows (2 % NULL), the build a permutation of [0, 2^20), 3 pad rows
    cap, bcap = 1 << 24, 1 << 20
    pkeys = rng.integers(0, bcap, cap).astype(np.int32)
    pok = (np.arange(cap) < cap - 17) & (rng.random(cap) > 0.02)
    bkeys = rng.permutation(bcap).astype(np.int32)
    bok = np.arange(bcap) < bcap - 3
    out["b"] = (bkeys, bok, pkeys, pok, table_size_for(bcap))
    # (c) long chains: tests/test_hash_join.py's 100 keys 4096 apart at 128
    # slots, and load 0.9 at 2^16 slots
    chain = np.arange(100, dtype=np.int64) * 4096
    out["c chains"] = (chain, np.ones(100, bool), chain, np.ones(100, bool),
                       128)
    n = int(0.9 * (1 << 16))
    bkeys = _unique_keys(rng, n, -(1 << 40), 1 << 40)
    npr = 1 << 18
    pkeys = np.where(rng.random(npr) < 0.8, rng.choice(bkeys, npr),
                     rng.integers(-(1 << 40), 1 << 40, npr))
    out["c load 0.9"] = (bkeys, np.ones(n, bool), pkeys,
                         rng.random(npr) >= 0.02, 1 << 16)
    return out


def hash_join_oracle(bkeys, bok, pkeys, pok):
    """(ri, matched) by np.searchsorted over the live build keys."""
    rows = np.nonzero(bok)[0]
    order = np.argsort(bkeys[rows], kind="stable")
    sk, sr = bkeys[rows][order], rows[order]
    pos = np.minimum(np.searchsorted(sk, pkeys), max(len(sk) - 1, 0))
    hit = pok & (sk[pos] == pkeys) if len(sk) else np.zeros_like(pok)
    return np.where(hit, sr[pos] if len(sk) else 0, 0).astype(np.int64), hit


def graph_median_ms(fn, runs=HJ_RUNS):
    """Median device ms of fn() over `runs` replays of a CUDA graph that
    holds one call, each replay between its own CUDA events (warm: two
    eager calls and one replay first). fn must read nothing back."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def eager_median_ms(fn, runs=HJ_PLAIN_RUNS):
    """Median ms of fn() between CUDA events, eager (one warm call first):
    for the plain versions, which read the device every round."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_build(b, bok):
    """The library route's build: one torch.sort of the build keys, dead
    rows last under the key type's largest value (which no probe key of
    (a) or (b) takes)."""
    import torch

    big = torch.iinfo(b.dtype).max
    return torch.sort(torch.where(bok, b, big))


def library_probe(sorted_keys, perm, bok, p, pok):
    """The library route's probe: torch.searchsorted, then gathers."""
    import torch

    pos = torch.searchsorted(sorted_keys, p).clamp_(
        max=sorted_keys.shape[0] - 1)
    row = perm[pos]
    hit = pok & (sorted_keys[pos] == p) & bok[row]
    return torch.where(hit, row, 0), hit


def sort_rank_join(b, bok, p, pok):
    """The port's sort-rank FK join: joint ranks, then the rank lookup."""
    from query_engine_tpu_torch.ops import kernels as K

    lr, rr = K.join_ranks([(p, pok)], [(b, bok)], pok, bok)
    return K.fk_join_right_lookup(lr, rr, pok, bok)


def phase17():
    """The open-addressing hash join (`ops/hash_join.py`) on the card: (a)
    TPU_DESIGN #10's shape, (b) bench.py's, (c) long chains, each through
    `hash_join_unique` with the counts at 0, held against the plain
    versions on the card, the numpy oracle and `check_table`; (d) a table
    too small raises. (a) and (b) time the kernels, the plain versions, the
    sort-rank route and the library route beside the bound."""
    import gc

    import torch

    from query_engine_tpu_torch.ops import hash_join as HJ

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_label()
    dev = torch.device("cuda")
    launches = {"hash_build": 0, "hash_probe": 0}
    by_case = {}
    for name, arrays in hash_join_cases().items():
        bkeys, bok, pkeys, pok, T = arrays
        b, bo, p, po = (torch.from_numpy(a).to(dev)
                        for a in (bkeys, bok, pkeys, pok))
        torch.cuda.synchronize()
        for k in HJ.launches:
            HJ.launches[k] = 0
        ri, m = HJ.hash_join_unique(p, po, b, bo, T)
        torch.cuda.synchronize()
        path = dict(HJ.launches)
        for k, v in path.items():
            check(v > 0, f"phase 17 ({name}): {k} did not launch")
            launches[k] += v
        want_ri, want_m = hash_join_oracle(bkeys, bok, pkeys, pok)
        check(np.array_equal(ri.cpu().numpy(), want_ri)
              and np.array_equal(m.cpu().numpy(), want_m),
              f"phase 17 ({name}): the hash join differs from the numpy "
              "oracle")
        tk, tr = HJ.hash_build(b, bo, T)
        HJ.check_table(tk, tr, b, bo)
        pk, pr = HJ.hash_build_plain(b, bo, T)
        HJ.check_table(pk, pr, b, bo)
        plain = HJ.hash_probe_unique_plain(pk, pr, p, po)
        kernel_on_kernel = HJ.hash_probe_unique(tk, tr, p, po)
        kernel_on_plain = HJ.hash_probe_unique(pk, pr, p, po)
        err = 0
        for label, (r2, m2) in (("the join", (ri, m)),
                                ("the probe on its table", kernel_on_kernel),
                                ("the probe on the plain table",
                                 kernel_on_plain)):
            check(torch.equal(m2, plain[1]) and torch.equal(r2, plain[0]),
                  f"phase 17 ({name}): {label} differs from the plain "
                  "version")
            err = max(err, int((r2 - plain[0]).abs().max()))
        same = torch.equal(tr, pr)
        rec = {"build_rows": int(bok.sum()), "probe_rows": int(pok.sum()),
               "T": T, "matched": int(m.sum()), "launches": path,
               "max_abs_err": err, "layout_equal_to_plain": same}
        print(f"phase 17 ({name}): {rec['build_rows']} live build rows, "
              f"{rec['probe_rows']} live probe rows, T = {T}, "
              f"{rec['matched']} matched: == numpy oracle and plain version; "
              f"the kernel's table passes check_table (layout equal to the "
              f"plain one: {same}); launches {path}")
        if name in ("a", "b"):
            rec.update(_hash_join_times(name, b, bo, p, po, T, want_ri,
                                        want_m, card))
        by_case[name] = rec
        del b, bo, p, po, tk, tr, pk, pr, plain, ri, m
        del kernel_on_kernel, kernel_on_plain
        gc.collect()
        torch.cuda.empty_cache()
    # (d) a table too small for its live rows
    keys = torch.arange(200, dtype=torch.int64, device=dev) * 4096
    ok = torch.ones(200, dtype=torch.bool, device=dev)
    for label, call in (("hash_build", lambda: HJ.hash_build(keys, ok, 128)),
                        ("hash_join_unique",
                         lambda: HJ.hash_join_unique(keys, ok, keys, ok,
                                                     128))):
        try:
            call()
        except ValueError as e:
            print(f"phase 17 (d): {label} at 200 live rows, T = 128: "
                  f"ValueError ({e})")
        else:
            raise CheckFailed(f"phase 17 (d): {label} took 200 live rows "
                              "into 128 slots")
    design = hash_join_design(card)
    seconds = time.perf_counter() - t_phase
    print(f"phase 17: {seconds:.1f} s; launches {launches} [{card}]")
    return {"cases": by_case, "launches": launches, "seconds": seconds,
            "design": design,
            "max_abs_err": max(r["max_abs_err"] for r in by_case.values())}


def _hash_join_times(name, b, bo, p, po, T, want_ri, want_m, card):
    """Phase 17's times at case (a) or (b), each route's result checked
    first: the kernels (build: the packed table's fill and the claims;
    probe), the plain versions, the sort-rank route, the library route, and
    the bound (each input read and each output written once, the table
    once, over 3.35 TB/s)."""
    from query_engine_tpu_torch.ops import hash_join as HJ

    kb = b.element_size()
    table = T * (kb + 4)
    build_bytes = b.numel() * (kb + 1) + table
    probe_in = p.numel() * (kb + 1)
    probe_out = p.numel() * (8 + 1)
    probe_bytes = table + probe_in + probe_out
    join_bytes = b.numel() * (kb + 1) + table + probe_in + probe_out
    tk, tr, _ = HJ._build_kernel(b, bo, T)
    for label, (r, m) in (
            ("sort-rank", sort_rank_join(b, bo, p, po)),
            ("library", library_probe(*library_build(b, bo), bo, p, po))):
        check(np.array_equal(r.cpu().numpy(), want_ri)
              and np.array_equal(m.cpu().numpy(), want_m),
              f"phase 17 ({name}): the {label} route differs from the "
              "oracle")
    sk, perm = library_build(b, bo)
    t = {
        "build_ms": graph_median_ms(lambda: HJ._build_kernel(b, bo, T)),
        "probe_ms": graph_median_ms(
            lambda: HJ._probe_kernel(tk, tr, p, po)),
        "join_ms": graph_median_ms(
            lambda: HJ._probe_kernel(*HJ._build_kernel(b, bo, T)[:2], p,
                                     po)),
        "plain_build_ms": eager_median_ms(
            lambda: HJ.hash_build_plain(b, bo, T)),
        "plain_probe_ms": eager_median_ms(
            lambda: HJ.hash_probe_unique_plain(tk, tr, p, po)),
        "sort_rank_ms": graph_median_ms(lambda: sort_rank_join(b, bo, p, po)),
        "library_build_ms": graph_median_ms(lambda: library_build(b, bo)),
        "library_probe_ms": graph_median_ms(
            lambda: library_probe(sk, perm, bo, p, po)),
        "build_bound_ms": bound_ms(build_bytes),
        "probe_bound_ms": bound_ms(probe_bytes),
        "join_bound_ms": bound_ms(join_bytes),
        "bytes": {"build": build_bytes, "probe": probe_bytes,
                  "join": join_bytes},
    }
    t["plain_ms"] = t["plain_build_ms"] + t["plain_probe_ms"]
    t["library_ms"] = t["library_build_ms"] + t["library_probe_ms"]
    for part in ("build", "probe", "join"):
        print(f"phase 17 ({name}) {part}: kernel {t[f'{part}_ms']:.4f} ms, "
              f"bound {t[f'{part}_bound_ms']:.4f} ms "
              f"({t['bytes'][part]:,} bytes), share "
              f"{t[f'{part}_bound_ms'] / t[f'{part}_ms']:.1%} [{card}]")
    print(f"phase 17 ({name}): plain build {t['plain_build_ms']:.3f} ms, "
          f"plain probe {t['plain_probe_ms']:.3f} ms; sort-rank route "
          f"(join_ranks + fk_join_right_lookup) {t['sort_rank_ms']:.4f} ms; "
          f"library route (torch.sort {t['library_build_ms']:.4f} + "
          f"searchsorted and gathers {t['library_probe_ms']:.4f}) "
          f"{t['library_ms']:.4f} ms; hash join {t['join_ms']:.4f} ms "
          f"[{card}]")
    return t


SF10_WARM = 3
# the queries of phase 18 profiled once each for their kernel time (a
# profiled replay of a query with subqueries has crashed the process)
SF10_PROFILED = ("Q1", "Q6", "Q9")
# the queries whose float error phase 18 prints apart: the two nearest to
# rtol 1e-9 at SF1 under one fixed-point word per float SUM
SF10_PRECISION = ("Q9", "F1")


def _to_mib(n):
    return n / 2**20


# the census never walks into these: they reach everything else
_CENSUS_STOP = ("Session", "QueryExecutor", "CompiledPipeline", "Evaluator")


def _cuda_storages(roots, skip=()):
    """{storage address: bytes} of the CUDA tensors reachable from `roots`
    through lists, tuples, dicts, sets and the port's own objects (not
    through a Session, executor, pipeline or evaluator), the ids in `skip`
    left out."""
    import gc

    import torch

    out, seen = {}, set(skip)
    stack = list(roots)
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                s = o.untyped_storage()
                out[s.data_ptr()] = s.nbytes()
            continue
        if isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif (type(o).__module__ or "").startswith("query_engine_tpu_torch") \
                and type(o).__name__ not in _CENSUS_STOP:
            stack.extend(gc.get_referents(o))
    return out


def _gc_cuda_storages(with_tensor=False):
    """The storages of every CUDA tensor the collector tracks (with the
    tensor), after a collection."""
    import gc
    import warnings

    import torch

    gc.collect()
    out = []
    with warnings.catch_warnings():
        # isinstance() on some of torch's module objects warns
        warnings.simplefilter("ignore")
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.is_cuda:
                s = o.untyped_storage()
                out.append((s, o) if with_tensor else s)
    return out


def memory_census(sess):
    """What holds the card's allocated memory, in MiB, each byte counted
    once in the first holder of this order: the registered tables' planes;
    the live graphs' outputs and the inputs they read (a captured entry's
    `outputs`, `planes`, `xfer`, row-count and literal buffers); anything
    else the pipeline's cached entries reach; the rest of the Session (its
    executor's caches and memos); other CUDA tensors the collector knows;
    and what no tensor accounts for (the rest of memory_allocated)."""
    import torch

    ex = sess.executor
    pipe = ex.pipeline
    entries = list(pipe._cache.values())
    live = [e for e in entries if e.graph is not None]
    parts = [
        ("tables", [s._batch for s in sess.sources.values()
                    if getattr(s, "_batch", None) is not None], ()),
        ("graphs", [(e.outputs, e.planes, e.xfer, e.n_bufs, e.dyn_bufs)
                    for e in live], ()),
        ("entries", entries, ()),
        ("session", [vars(sess), vars(ex), vars(pipe),
                     vars(ex.evaluator)], (id(pipe._cache),)),
    ]
    counted, out = {}, {}
    for name, roots, skip in parts:
        found = _cuda_storages(roots, skip)
        new = {p: n for p, n in found.items() if p not in counted}
        counted.update(new)
        out[name] = _to_mib(sum(new.values()))
    other = {}
    for s in _gc_cuda_storages():
        if s.data_ptr() not in counted:
            other[s.data_ptr()] = s.nbytes()
    out["other_tensors"] = _to_mib(sum(other.values()))
    out["no_tensor"] = (_to_mib(torch.cuda.memory_allocated())
                        - sum(out.values()))
    out["programs"] = len(entries)
    out["live_graphs"] = len(live)
    return {k: round(v, 1) if isinstance(v, float) else v
            for k, v in out.items()}


def _holder_chain(obj, skip, depth=8):
    """What keeps `obj` alive, nearest first: each referrer's type (a
    dict's key that holds the step before; a module's global by name),
    frames and the ids in `skip` left out."""
    import gc
    import types

    # plain loops: a closure over `obj` would itself refer to it
    chain, skip = [], set(skip)
    for _ in range(depth):
        refs = gc.get_referrers(obj)
        skip.add(id(refs))
        r = None
        for x in refs:
            if id(x) not in skip and not isinstance(x, types.FrameType):
                r = x
                break
        del refs, x
        if r is None:
            break
        if isinstance(r, dict):
            key = None
            for k, v in r.items():
                if v is obj:
                    key = k
                    break
            if "__builtins__" in r:  # a module's globals
                chain.append(f"module {r.get('__name__')}.{key}")
                break
            chain.append(f"dict[{key!r}]" if isinstance(key, str)
                         else "dict")
        else:
            chain.append(type(r).__name__)
        obj = r
    return chain


def leftover_tensors(top=5):
    """The largest CUDA tensors the collector still knows: (MiB, shape,
    dtype, what holds it, nearest first)."""
    found = {}
    for s, o in _gc_cuda_storages(with_tensor=True):
        found.setdefault(s.data_ptr(), (s.nbytes(), o))
    skip = {id(found)} | {id(v) for v in found.values()}
    rows = []
    for n, t in sorted(found.values(), key=lambda x: -x[0])[:top]:
        rows.append((round(_to_mib(n), 1), tuple(t.shape), str(t.dtype),
                     _holder_chain(t, skip | {id(rows)})))
    return rows


def phase_memory(tag):
    """After a phase: the allocated device memory with its Sessions freed,
    and, past 64 MiB, the largest CUDA tensors left and their holders."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    left = leftover_tensors() if after > 64 << 20 else []
    print(f"after phase {tag}: {_to_mib(after):.0f} MiB allocated"
          + (f"; largest CUDA tensors left (MiB, shape, dtype, holders) "
             f"{left}" if left else ""))
    return _to_mib(after)


def sf10_statements():
    """(name, text, oracle(tables), compare(rows, want)) of phase 18: the
    22 TPC-H queries (Q11 with TPC-H's FRACTION for SF10), then F1 and F6
    of tpch/scalar.py."""
    from query_engine_tpu_torch.tpch import oracle, queries, scalar

    out = []
    for q, text in queries.QUERIES.items():
        keys = oracle.FLOAT_SORT_KEYS.get(q, ())
        if q == "Q11":
            text, run = queries.Q11_SF10, oracle.q11_sf10
        else:
            run = (lambda t, q=q: oracle.run(q, t))
        out.append((q, text, run,
                    lambda rows, want, keys=keys: oracle.compare(rows, want,
                                                                 keys)))
    for q in ("F1", "F6"):
        out.append((q, scalar.QUERIES[q], lambda t, q=q: scalar.run(q, t),
                    lambda rows, want, q=q: scalar.compare(q, rows, want)))
    return out


def phase18(hold=None):
    """The 22 TPC-H queries and F1, F6 at scale factor 10 through one
    Session(device="cuda"), each against the numpy oracle on its first run
    and SF10_WARM warm runs. With a list `hold`, the host tables and the
    Session are appended to it for phase 19 and not freed here."""
    import gc

    import torch

    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.tpch import data, oracle, scalar

    t_phase = time.perf_counter()
    card = card_label()
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tables = data.generate(data.SF10_LINEITEM)
    gen_s = time.perf_counter() - t0
    sess = Session(device="cuda")
    check(sess.executor._compiled, "QE_COMPILED is off in this environment")
    t0 = time.perf_counter()
    data.register(sess, tables)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    table_mib = _to_mib(torch.cuda.memory_allocated() - mem0)
    caps = {k: sess.sources[k]._batch.capacity for k in ("lineitem",
                                                         "orders")}
    sizes = ", ".join(f"{k} {t.num_rows:,}" for k, t in tables.items())
    print(f"phase 18: TPC-H SF10 tables generated on the host in {gen_s:.2f} "
          f"s and registered on the card in {reg_s:.2f} s: {sizes}; "
          f"{table_mib:.0f} MiB allocated by the tables; capacities {caps} "
          f"[{card}]")
    torch.cuda.reset_peak_memory_stats()
    pipe = sess.executor.pipeline
    timing = ("leaf_ms", "capture_ms")
    out, held = {}, {}
    for q, text, run, compare in sf10_statements():
        t0 = time.perf_counter()
        want = run(tables)
        oracle_s = time.perf_counter() - t0
        st0, syncs0 = dict(pipe.stats), sess.executor.host_syncs
        held[q] = []
        spy = IndexAddSpy()
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held[q], spy):
            t0 = time.perf_counter()
            rows = sess.sql(text).to_pylist()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()["group_agg"]
        first = _stats_change(st0, pipe.stats, timing)
        first_syncs = sess.executor.host_syncs - syncs0
        errs = []

        def held_to_oracle(got, label):
            try:
                errs.append(compare(got, want))
            except AssertionError as e:
                raise CheckFailed(f"{q} at SF10: {label} differs from the "
                                  f"numpy oracle: {e}") from None
            if q in SF10_PRECISION:
                for c, v in scalar.float_errors(got, want).items():
                    col_err[c] = max(col_err.get(c, 0.0), v)

        col_err = {}
        held_to_oracle(rows, "the first run")
        check(rows, f"{q} at SF10 returned no rows")
        walls = []
        st1, syncs1 = dict(pipe.stats), sess.executor.host_syncs
        for i in range(SF10_WARM):
            t0 = time.perf_counter()
            with spy.active():
                again = sess.sql(text).to_pylist()
            walls.append((time.perf_counter() - t0) * 1e3)
            held_to_oracle(again, f"warm run {i + 1}")
        ms = statistics.median(walls)
        syncs = (sess.executor.host_syncs - syncs1) / SF10_WARM
        warm = {k: v / SF10_WARM
                for k, v in _stats_change(st1, pipe.stats, timing).items()}
        busy = wall = None
        names = set()
        if q in SF10_PROFILED:
            busy, wall, names = device_ms(sess, text)
        torch.cuda.synchronize()
        alloc, reserved = (_to_mib(torch.cuda.memory_allocated()),
                           _to_mib(torch.cuda.memory_reserved()))
        census = memory_census(sess)
        err = max(errs)
        out[q] = {"rows": len(rows), "ms": ms, "first_ms": first_ms,
                  "syncs": syncs, "first_syncs": first_syncs,
                  "first": first, "warm": warm,
                  "captures_per_warm_query": warm.get("captures", 0),
                  "joins_demoted": first.get("joins_demoted", 0),
                  "joins_counted": first.get("joins_counted", 0),
                  "group_agg": launches, "max_rel_err": err,
                  "col_err": col_err, "oracle_s": oracle_s,
                  "device_ms": busy, "profiled_wall_ms": wall,
                  "group_agg_kernels": kernel_names(names, "sum_count_",
                                                    "float_absmax"),
                  "index_add_kernels": kernel_names(names, "indexFunc"),
                  "index_add_calls": spy.calls,
                  "allocated_mib": alloc, "reserved_mib": reserved,
                  "cache_entries": len(pipe._cache),
                  "oom_retries": first.get("oom_retries", 0),
                  "warm_oom_retries": warm.get("oom_retries", 0),
                  "graphs_released": first.get("graphs_released", 0),
                  "warm_graphs_released": warm.get("graphs_released", 0),
                  "census_mib": census}
        profiled = ("" if busy is None else
                    f"; one profiled warm run: {busy:.3f} ms of kernel time "
                    f"in {wall:.3f} ms wall, group_agg kernels "
                    f"{out[q]['group_agg_kernels']}")
        print(f"phase 18: {q}: {len(rows)} rows == numpy oracle on the first "
              f"and {SF10_WARM} warm runs (max rel err {err:.3g}, oracle "
              f"{oracle_s:.2f} s); {ms:.3f} ms/query median of {SF10_WARM} "
              f"warm runs, {syncs:g} host syncs/query, "
              f"{out[q]['captures_per_warm_query']:g} captures/warm query; "
              f"first run {first_ms:.1f} ms, {first_syncs} syncs, stats "
              f"{first}; warm stats per query {warm}; joins demoted "
              f"{out[q]['joins_demoted']}, counted "
              f"{out[q]['joins_counted']}; group_agg launches {launches}, "
              f"{len(held[q])} calls held against the plain versions; "
              f"index_add_ calls {spy.calls}; after it {alloc:.0f} MiB "
              f"allocated, {reserved:.0f} MiB reserved, "
              f"{len(pipe._cache)} cached programs{profiled}")
        print(f"phase 18: {q}: out-of-memory reruns {out[q]['oom_retries']} "
              f"first, {out[q]['warm_oom_retries']:g} per warm run; graphs "
              f"released {out[q]['graphs_released']} first, "
              f"{out[q]['warm_graphs_released']:g} per warm run; census MiB "
              f"{census}")
        if q in SF10_PRECISION:
            print(f"phase 18: {q}: largest relative error by float column "
                  f"{ {c: float(f'{v:.3g}') for c, v in col_err.items()} } "
                  f"(rtol {RTOL}: {100 * max(col_err.values(), default=0) / RTOL:.2g} % of it)")
    for q in TPCH_GROUP_AGG + ("F1", "F6"):
        check(out[q]["group_agg"] > 0, f"{q} at SF10: group_agg did not "
              "launch")
        check(held[q], f"{q} at SF10: no group_agg call of its first run "
              "was held against the plain versions")
    for q in SF10_PROFILED:
        check(out[q]["device_ms"] is not None
              and (out[q]["group_agg_kernels"] or q == "Q6"),
              f"{q} at SF10: no group_agg kernel in its profiled warm run")
    for q, r in out.items():
        check(not r["index_add_calls"] and not r["index_add_kernels"],
              f"{q} at SF10: index_add_ on the card: {r['index_add_calls']} "
              f"calls, kernels {r['index_add_kernels']}")
    margins = oracle.margins(tables)
    print("phase 18: closest row to its threshold (relative, in the "
          "oracle's float64): " + ", ".join(
              f"{k} {v:.6g}" for k, v in margins.items()))
    peak = {"allocated_mib": _to_mib(torch.cuda.max_memory_allocated()),
            "reserved_mib": _to_mib(torch.cuda.max_memory_reserved())}
    total = sum(r["ms"] for r in out.values())
    err = max((c["max_abs_err"] for calls in held.values() for c in calls),
              default=0.0)
    seconds = time.perf_counter() - t_phase
    print(f"phase 18: {len(out)} statements at SF10: {total:.1f} ms in all "
          f"(sum of the warm medians); peak {peak['allocated_mib']:.0f} MiB "
          f"allocated, {peak['reserved_mib']:.0f} MiB reserved; "
          f"generation {gen_s:.2f} s, registration {reg_s:.2f} s; the phase "
          f"took {seconds:.1f} s [{card}]")
    result = {"queries": out, "launches": {q: r["group_agg"]
                                           for q, r in out.items()},
              "max_abs_err": err, "peak": peak, "seconds": seconds,
              "table_mib": table_mib, "mem0": mem0}
    del pipe
    if hold is not None:
        sf10_checks(out, "phase 18")
        hold.extend([tables, sess])
        return result
    del tables, sess
    result["freed"] = sf10_freed("phase 18", mem0)
    sf10_checks(out, "phase 18")
    return result


# the allocated memory a freed SF10 Session may leave above the phase's
# start (the allocator's rounding, the built kernels' buffers)
SF10_FREED_SLACK = 256 << 20


def sf10_freed(tag, mem0):
    """After the SF10 Session and tables are dropped by their holders: the
    allocated memory against `mem0`, the phase's start, and the largest
    CUDA tensors still alive. Fails past SF10_FREED_SLACK."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    left = leftover_tensors()
    card = card_label()
    print(f"{tag}: {_to_mib(after):.0f} MiB allocated after the SF10 "
          f"Session is freed, {_to_mib(mem0):.0f} MiB at the start of phase "
          f"18 ({_to_mib(after - mem0):+.0f} MiB); largest CUDA tensors "
          f"left (MiB, shape, dtype, referrers) {left} [{card}]")
    check(after - mem0 <= SF10_FREED_SLACK, f"{tag}: the freed SF10 "
          f"Session left {_to_mib(after - mem0):.0f} MiB allocated above the "
          "phase's start")
    return {"allocated_mib": _to_mib(after), "mem0_mib": _to_mib(mem0),
            "left": left}


def sf10_checks(out, tag):
    """No statement of an SF10 phase ran out of device memory (a rerun
    after every cached graph was released) on its first or a warm run."""
    oom = {q: (r["oom_retries"], r["warm_oom_retries"])
           for q, r in out.items()
           if r["oom_retries"] or r["warm_oom_retries"]}
    check(not oom, f"{tag}: out-of-memory reruns (first, per warm run): "
          f"{oom}")


# phase 19: the statements whose float window error is printed against its
# allowance, and those profiled once (a warm run each)
SF10_WINDOW_ERRORS = ("W2", "W3", "W4", "W5")
SF10_MORE_PROFILED = ("W1", "J1")


def sf10_more_statements():
    """(group, name, text, oracle(tables), compare(rows, want)) of phase 19:
    tpch/windows.py's eleven, tpch/scalar.py's F2-F5, tpch/ordered.py's
    eight and tpch/count_emit.py's J1-J4c, G1a and G1b, texts as at SF1.
    A window query's oracle returns (rows, allowance by column) and its
    compare (largest abs error in an allowed column, largest rel error)."""
    from query_engine_tpu_torch.tpch import count_emit as CE
    from query_engine_tpu_torch.tpch import ordered, scalar, windows

    out = [("windows", q, text,
            lambda t, q=q: (windows.run(q, t), windows.allowance(q, t)),
            lambda rows, want, q=q: windows.compare(q, rows, *want))
           for q, text in windows.QUERIES.items()]
    out += [("scalar", q, scalar.QUERIES[q],
             lambda t, q=q: scalar.run(q, t),
             lambda rows, want, q=q: (0.0, scalar.compare(q, rows, want)))
            for q in ("F2", "F3", "F4", "F5")]
    out += [("ordered", q, text, lambda t, q=q: ordered.run(q, t),
             lambda rows, want, q=q: (0.0, ordered.compare(q, rows, want)))
            for q, text in ordered.QUERIES.items()]
    out += [("count_emit", q, CE.QUERIES[q], lambda t, q=q: CE.run(q, t),
             lambda rows, want, q=q: (0.0, CE.compare(q, rows, want)))
            for q in CE.QUERIES if q not in CE.FD_QUERIES]
    return out


def phase19(hold):
    """Phases 8-10's and 15's statements at SF10 on phase 18's Session and
    tables (`hold`: [tables, session], emptied here), each against its
    numpy oracle on its first run and SF10_WARM warm runs."""
    import torch

    from query_engine_tpu_torch.columnar.batch import padded_capacity
    from query_engine_tpu_torch.engine import pipeline as P
    from query_engine_tpu_torch.tpch import count_emit as CE
    from query_engine_tpu_torch.tpch import ordered, scalar, windows

    tables, sess = hold
    hold.clear()
    t_phase = time.perf_counter()
    card = card_label()
    ex = sess.executor
    pipe = ex.pipeline
    timing = ("leaf_ms", "capture_ms")
    torch.cuda.reset_peak_memory_stats()
    li_cap = sess.sources["lineitem"]._batch.capacity
    out, held = {}, {}
    for group, q, text, run, compare in sf10_more_statements():
        t0 = time.perf_counter()
        want = run(tables)
        oracle_s = time.perf_counter() - t0

        def held_to_oracle(got, label):
            try:
                return compare(got, want)
            except AssertionError as e:
                raise CheckFailed(f"phase 19: {q} at SF10: {label} differs "
                                  f"from the numpy oracle: {e}") from None

        st0, syncs0 = dict(pipe.stats), ex.host_syncs
        kinds0 = collections.Counter(pipe.leaf_kinds)
        held[q] = []
        spy = IndexAddSpy()
        reset_counts()
        with spy.active(), group_agg_held_against_plain(held[q], spy):
            t0 = time.perf_counter()
            rows = sess.sql(text).to_pylist()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()["group_agg"]
        first = _stats_change(st0, pipe.stats, timing)
        first_syncs = ex.host_syncs - syncs0
        rounds = sess.recursion.get("iterations") if q == "O6" else None
        err = held_to_oracle(rows, "the first run")
        check(rows, f"phase 19: {q} at SF10 returned no rows")
        walls, bits = [], []
        st1, syncs1 = dict(pipe.stats), ex.host_syncs
        for i in range(SF10_WARM):
            t0 = time.perf_counter()
            with spy.active():
                batch = sess.sql(text)
                again = batch.to_pylist()
            walls.append((time.perf_counter() - t0) * 1e3)
            if q in windows.FLOAT_SUMS:
                bits.append(_float_planes(batch))
            if again != rows:  # else equal to the oracle as the first run
                e = held_to_oracle(again, f"warm run {i + 1}")
                err = (max(err[0], e[0]), max(err[1], e[1]))
        del batch
        ms = statistics.median(walls)
        syncs = (ex.host_syncs - syncs1) / SF10_WARM
        warm = {k: v / SF10_WARM
                for k, v in _stats_change(st1, pipe.stats, timing).items()}
        leaves = sorted(pipe.leaf_kinds - kinds0)
        busy = wall = None
        names = set()
        if q in SF10_MORE_PROFILED:
            with spy.active():
                busy, wall, names = device_ms(sess, text)
        torch.cuda.synchronize()
        alloc, reserved = (_to_mib(torch.cuda.memory_allocated()),
                           _to_mib(torch.cuda.memory_reserved()))
        census = memory_census(sess)
        r = out[q] = {
            "group": group, "rows": len(rows), "first_ms": first_ms,
            "ms": ms, "syncs": syncs, "first_syncs": first_syncs,
            "first": first, "warm": warm,
            "captures_per_warm_query": warm.get("captures", 0),
            "eager_leaves": leaves, "group_agg": launches,
            "group_agg_slots": sorted({c["groups"] for c in held[q]}),
            "max_abs_err": err[0], "max_rel_err": err[1],
            "allowance": want[1] if group == "windows" else {},
            "oracle_s": oracle_s, "oom_retries": first.get("oom_retries", 0),
            "warm_oom_retries": warm.get("oom_retries", 0),
            "graphs_released": first.get("graphs_released", 0),
            "warm_graphs_released": warm.get("graphs_released", 0),
            "allocated_mib": alloc, "reserved_mib": reserved,
            "census_mib": census, "device_ms": busy,
            "profiled_wall_ms": wall,
            "group_agg_kernels": kernel_names(names, "sum_count_",
                                              "float_absmax"),
            "index_add_kernels": kernel_names(names, "indexFunc"),
            "index_add_calls": spy.calls, "rounds": rounds}
        profiled = ("" if busy is None else
                    f"; one profiled warm run: {busy:.3f} ms of kernel time "
                    f"in {wall:.3f} ms wall, group_agg kernels "
                    f"{r['group_agg_kernels']}")
        print(f"phase 19: {q}: {len(rows)} rows == numpy oracle on the first "
              f"and {SF10_WARM} warm runs (max rel err {err[1]:.3g}, oracle "
              f"{oracle_s:.2f} s); first run {first_ms:.1f} ms, "
              f"{first_syncs} syncs, stats {first}; {ms:.3f} ms/query median "
              f"of {SF10_WARM} warm runs, {syncs:g} host syncs/query, "
              f"{r['captures_per_warm_query']:g} captures/warm query, warm "
              f"stats per query {warm}; eager leaves {leaves}; group_agg "
              f"launches {launches} at slots {r['group_agg_slots']}, "
              f"{len(held[q])} calls held against the plain versions; "
              f"index_add_ calls {spy.calls}; out-of-memory reruns "
              f"{r['oom_retries']} first, {r['warm_oom_retries']:g} per warm "
              f"run; graphs released {r['graphs_released']} first, "
              f"{r['warm_graphs_released']:g} per warm run; after it "
              f"{alloc:.0f} MiB allocated, {reserved:.0f} MiB reserved, "
              f"{len(pipe._cache)} cached programs; census MiB {census}"
              f"{profiled} [{card}]")
        if q in SF10_WINDOW_ERRORS:
            allow = {c: float(f"{v:.6g}") for c, v in r["allowance"].items()}
            share = (f" ({100 * err[0] / max(r['allowance'].values()):.3g} % "
                     "of it)" if r["allowance"] else "")
            print(f"phase 19: {q}: largest float window error {err[0]:.6g} "
                  f"against the allowance by column {allow}{share}, largest "
                  f"relative error {err[1]:.3g} [{card}]")
        if q == "O6":
            print(f"phase 19: O6: {rounds} rounds")

        # the structural checks of phases 8-10 and 15
        check(not spy.calls and not r["index_add_kernels"],
              f"phase 19: {q}: index_add_ on the card ({spy.calls} calls, "
              f"kernels {r['index_add_kernels']})")
        check(not launches or held[q], f"phase 19: {q}: no group_agg call of "
              "its first run was held against the plain versions")
        if group == "windows":
            untraced = [k for k in leaves if k in TRACED_NODES
                        and not (k == "SetOp" and q in STRING_SETOPS)]
            check(not untraced, f"phase 19: {q}: {untraced} ran as eager "
                  "leaves of a compiled run")
            if q in windows.FLOAT_SUMS:
                check(bits[0] and all(
                    torch.equal(a, b) for run_bits in bits[1:]
                    for a, b in zip(bits[0], run_bits)),
                    f"phase 19: {q}: a float window sum's bits differ "
                    "between warm runs")
        elif group == "scalar":
            allowed = STRING_FN_LEAVES.get(q, ())
            check(all(k in allowed for k in leaves), f"phase 19: {q}: "
                  f"{leaves} ran as eager leaves of a compiled run")
            if q in scalar.GROUP_AGG:
                check(not warm.get("captures"),
                      f"phase 19: {q}: a warm run captured again ({warm})")
        elif group == "ordered" and q == "O6":
            check(rounds == ordered.RECURSION_DEPTH,
                  f"phase 19: O6 ran {rounds} rounds, not "
                  f"{ordered.RECURSION_DEPTH}")
        elif group == "count_emit":
            check(not first.get("fallbacks") and (first.get("compiles")
                                                   or first.get("hits")),
                  f"phase 19: {q} did not run in the compiled pipeline: "
                  f"{first}")
            check(not first.get("joins_demoted"),
                  f"phase 19: {q}: a join was demoted: {first}")
            if q in CE.JOINS:
                check("HashJoin" not in leaves, f"phase 19: {q}: its join "
                      f"ran as an eager leaf: {leaves}")
            if q in CE.COUNTED:
                check(first.get("joins_counted", 0) >= 1, f"phase 19: {q}: "
                      f"no count program sized it: {first}")
            if q in CE.SORT_REUSED:
                check(first.get("join_sorts_reused", 0) >= 1,
                      f"phase 19: {q}: the emit program did not reuse the "
                      f"count's sort: {first}")
            if q in CE.GROUPING_REUSED:
                bucket = padded_capacity(len(rows))
                check(first.get("group_sorts_reused", 0) >= 1
                      and launches > 0 and r["group_agg_slots"] == [bucket],
                      f"phase 19: {q}: not aggregated through group_agg at "
                      f"padded(ng) = {bucket} slots with the count's "
                      f"grouping: slots {r['group_agg_slots']}, {first}")
            if not leaves:
                check(not warm.get("captures") and not warm.get("compiles"),
                      f"phase 19: {q}: a warm run compiled or captured "
                      f"anew: {warm}")
    # group_agg launches where it launched at SF1 (phases 8-10 and 15)
    for q in (windows.GROUP_AGG
              + tuple(q for q in scalar.GROUP_AGG if q in out)
              + ORDERED_GROUP_AGG
              + tuple(q for q, r in out.items() if r["group"] == "count_emit")):
        check(out[q]["group_agg"] > 0, f"phase 19: {q} at SF10: group_agg "
              "did not launch")
    # J1's partsupp side has multiplicity 2: at SF1 a static emit at
    # lineitem's capacity x 2; at SF10 that is 2^27 slots, past the
    # pipeline's _MAX_EMIT (as the reference's), so by the same rule a
    # count program sizes it and the emit runs at the counted rows
    j1_counted = li_cap * 2 > P._MAX_EMIT
    print(f"phase 19: J1: lineitem's capacity {li_cap:,} x 2 "
          f"{'>' if j1_counted else '<='} _MAX_EMIT {P._MAX_EMIT:,}: "
          f"{'counted' if j1_counted else 'a static emit'}; joins counted "
          f"{out['J1']['first'].get('joins_counted', 0)}")
    check((out["J1"]["first"].get("joins_counted", 0) >= 1) == j1_counted,
          f"phase 19: J1 was {'not ' if j1_counted else ''}counted: "
          f"{out['J1']['first']}")
    for q in SF10_MORE_PROFILED:
        check(out[q]["device_ms"] is not None,
              f"phase 19: {q}: its profiled warm run did not run")
    sf10_checks(out, "phase 19")
    peak = {"allocated_mib": _to_mib(torch.cuda.max_memory_allocated()),
            "reserved_mib": _to_mib(torch.cuda.max_memory_reserved())}
    seconds = time.perf_counter() - t_phase
    total = sum(r["ms"] for r in out.values())
    oracle_s = sum(r["oracle_s"] for r in out.values())
    by_group = collections.Counter(r["group"] for r in out.values())
    print(f"phase 19: {len(out)} statements at SF10 ({dict(by_group)}): "
          f"{total:.1f} ms in all (sum of the warm medians); oracles "
          f"{oracle_s:.1f} s; peak {peak['allocated_mib']:.0f} MiB "
          f"allocated, {peak['reserved_mib']:.0f} MiB reserved; the phase "
          f"took {seconds:.1f} s [{card}]")
    errs = [c["max_abs_err"] for calls in held.values() for c in calls]
    return {"queries": out, "seconds": seconds, "peak": peak,
            "launches": {q: r["group_agg"] for q, r in out.items()},
            "max_abs_err": max(errs, default=0.0)}


def hash_join_entries(hash_join, engine_hj):
    """The kernels line's hash_build and hash_probe entries: launches from
    phase 17's runs of the entry point, times at case (a), every case's
    numbers under by_case and the whole join's under join."""
    a = hash_join["cases"]["a"]
    return [{
        "name": name,
        "route": "cuda",
        "source": HJ_SOURCE,
        "replaces": HJ_REPLACES[name],
        "launches": hash_join["launches"][name],
        "launches_by_phase": {"1-16": engine_hj[name],
                              "17": {c: r["launches"][name] for c, r
                                     in hash_join["cases"].items()}},
        "max_abs_err": hash_join["max_abs_err"],
        "ms": a[f"{part}_ms"],
        "plain_ms": a[f"plain_{part}_ms"],
        "bound_ms": a[f"{part}_bound_ms"],
        "bound_by": "bytes",
        "library_ms": a[f"library_{part}_ms"],
        "by_case": {c: {k: hash_join["cases"][c][k] for k in
                        (f"{part}_ms", f"{part}_bound_ms",
                         f"plain_{part}_ms", f"library_{part}_ms")}
                    for c in ("a", "b")},
        "join": {c: {k: hash_join["cases"][c][k] for k in
                     ("join_ms", "join_bound_ms", "plain_ms",
                      "sort_rank_ms", "library_ms")} for c in ("a", "b")},
        "design": {k: v for k, v in hash_join["design"].items()
                   if k.startswith(part)},
    } for name, part in (("hash_build", "build"), ("hash_probe", "probe"))]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    try:
        import query_engine_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAIL: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    from query_engine_tpu_torch.ops import hash_join as HJ

    try:
        phase0()
        max_err, times = phase1()
        tables = make_tables(torch.device("cuda"))
        eager_ms = phase2(tables)
        g_err, g_times = phase3()
        agg_launches, agg_names = phase4(tables, eager_ms)
        b = phase5(tables)
        p6_launches, p6_err, p6_times = phase6()
        tpch, tpch_held, sf1_tables, sf1_sess = phase7()
        windows = phase8(sf1_tables, sf1_sess)
        scalar_fns = phase9(sf1_tables, sf1_sess)
        ordered_sets = phase10(sf1_tables, sf1_sess)
        # phase 11 runs on a Session of its own: free the earlier ones
        del sf1_sess, tables
        session_surface = phase11(sf1_tables)
        phase_memory("11")
        services = phase12(sf1_tables)
        phase_memory("12")
        distributed = phase13(sf1_tables)
        phase_memory("13")
        mesh = phase14(sf1_tables)
        phase_memory("14")
        count_emit = phase15(sf1_tables)
        phase_memory("15")
        mesh_sql = phase16(sf1_tables)
        phase_memory("16")
        # nothing before phase 17 routes a join through the hash table
        engine_hj = dict(HJ.launches)
        check(not any(engine_hj.values()),
              f"phases 1-16 launched the hash join's kernels: {engine_hj}")
        hash_join = phase17()
        phase_memory("17")
        del sf1_tables  # phase 18 holds SF10's tables alone
        sf10_run = []  # phase 18's host tables and Session, for phase 19
        sf10 = phase18(sf10_run)
        sf10_more = phase19(sf10_run)
        sf10["freed"] = sf10_freed("phases 18-19", sf10["mem0"])
    except CheckFailed as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    main_shape = times["main path shape"]
    # Query B's gather: the join's form, 1024 rows, 1 word
    gather = g_times["planes T=1024 W=1"]
    tpch_by_query = {q: r["group_agg"] for q, r in tpch.items()}
    tpch_launches = sum(tpch_by_query.values())
    windows_by_query = {q: r["group_agg"] for q, r in windows.items()}
    scalar_by_query = {q: r["group_agg"] for q, r in scalar_fns.items()}
    ordered_by_query = {q: r["group_agg"] for q, r in ordered_sets.items()}
    surface_by_group = session_surface["launches"]
    services_by_part = services["launches"]
    p13 = distributed["launches"]
    p13_launches = sum(p13["13a"].values()) + sum(p13["13b"].values()) \
        + p13["13c"]
    p14 = mesh["launches"]
    p15 = count_emit["launches"]
    p16 = mesh_sql["launches"]
    p18 = sf10["launches"]
    p19 = sf10_more["launches"]
    tpch_err = max((c["max_abs_err"] for calls in tpch_held.values()
                    for c in calls), default=0.0)
    print(json.dumps({"kernels": [{
        "name": "group_agg",
        "route": "cuda",
        "source": "query_engine_tpu_torch/csrc/group_agg.cu",
        "replaces": "query_engine_tpu/ops/pallas/group_agg.py:74",
        "launches": agg_launches + tpch_launches
        + sum(windows_by_query.values()) + sum(scalar_by_query.values())
        + sum(ordered_by_query.values()) + sum(surface_by_group.values())
        + sum(services_by_part.values()) + p13_launches
        + sum(p14.values()) + sum(p15.values()) + sum(p16.values())
        + sum(p18.values()) + sum(p19.values()),
        "launches_by_phase": {"4": agg_launches, "7": tpch_by_query,
                              "8": windows_by_query, "9": scalar_by_query,
                              "10": ordered_by_query,
                              "11": surface_by_group,
                              "12": services_by_part, "13": p13,
                              "14": p14, "15": p15, "16": p16, "18": p18,
                              "19": p19},
        "max_abs_err": max_err["plain"],
        "max_abs_err_vs_float64": {"1": max_err["float64"], "7": tpch_err,
                                   "12": services["max_abs_err"],
                                   "13": distributed["max_abs_err"],
                                   "14": mesh["max_abs_err"],
                                   "15": count_emit["max_abs_err"],
                                   "16": mesh_sql["max_abs_err"],
                                   "18": sf10["max_abs_err"],
                                   "19": sf10_more["max_abs_err"]},
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_shape["library_ms"],
        "by_shape": times,
        "in_replay": agg_names,
    }, {
        "name": "small_gather_u32",
        "route": "cuda",
        "source": "query_engine_tpu_torch/csrc/small_gather.cu",
        "replaces": "query_engine_tpu/ops/pallas/small_gather.py:40",
        "launches": b["set"][1]["small_gather"],
        "max_abs_err": g_err,
        "ms": gather["ms"],
        "plain_ms": gather["plain_ms"],
        "bound_ms": gather["bound_ms"],
        "bound_by": "bytes",
        "library_ms": gather["library_ms"],
        "by_shape": g_times,
        "in_replay": b["set"][2],
        "join_ms": {"unset": b["unset"][3], "set": b["set"][3]},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": p6_launches[f"onehot_{v}"],
        "max_abs_err": p6_err,
        "ms": p6_times[v]["ms"],
        "plain_ms": p6_times[v]["plain_ms"],
        "bound_ms": p6_times[v]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": p6_times[v]["library_ms"],
        "entry_ms": p6_times[v]["entry_ms"],
        "v0_ms": p6_times[v]["v0_ms"],
    } for v, (name, source, replaces) in ONEHOT_KERNELS.items()]
        + hash_join_entries(hash_join, engine_hj)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
