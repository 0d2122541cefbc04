#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`query_engine_tpu_torch`) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phase 0  prints the card's name and power limit and builds the CUDA kernels
         from `query_engine_tpu_torch/csrc` with nvcc (sm_90a).
Phase 1  holds the grouped SUM/COUNT kernel against its plain PyTorch
         version on the same CUDA tensors: the main path's shape (2^23 rows,
         2048 groups, one int64 column and COUNT(*)), 32768 groups (int64
         and float64: the device-memory path), int64 values near +-2^62
         (wrap-around) and float64 with +inf, -inf and NaN. Integers must
         match exactly, floats within the tolerance below; two kernel runs
         must give identical bits. Times both versions at 2^23 rows.
Phase 2  runs the engine's eager path (the compiled pipeline off for this
         Session) through `Session(device="cuda").sql` at 2^23 - 17 fact
         rows and 1024 dimension rows (Query A, the bench query), checks
         that it launched the kernel, and compares the 10 rows exactly with
         an independent numpy oracle. Prints ms per query, rows/s, the
         number of host syncs per query, and one profiled query's device
         time by operator (torch.profiler).
Phase 3  holds the small-table gather kernel against its plain version at
         2^23 rows, tables of 1024 and 4096 rows and 1 and 3 words, indices
         of -1 and out of range included: bit-exact. Times both versions.
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
         both, and with the gate set the small gather kernel appears among
         the CUDA kernels of a profiled replayed query.

Phase 6  drives the aggregate probes' entry points (`probes.probe_agg_variants
         .run_variant` v1, v2, v4, v5 and `probes.probe_int8_mxu
         .grouped_sum_count_s8`), which run the four one-hot tensor-core
         kernels, at 2^24 rows and 1024 groups on three data sets: the
         probe's (seed 3), all groups and lanes over the whole int64 range,
         and a sparse wrap-around case (1 % of rows in 7 groups, values near
         +-2^63). Sums and counts must equal the numpy oracle and
         v0_production (the group_agg kernel), with the same bits on a second
         run; each kernel's [G, L] chunk totals must equal its plain
         version's bit for bit. On the probe's data it times each kernel,
         its plain version, its entry point and v0 (CUDA events) and prints
         rows/s, the tensor-core TFLOP/s and the input GB/s.
Phase 7  builds the TPC-H tables at scale factor 1 (6,001,215 lineitem
         rows; tpch/data.py) on the card and runs the twelve subquery-free
         queries through Session(device="cuda").sql. Each query's rows must
         equal the numpy oracle (tpch/oracle.py): integers, strings and
         dates exactly, floats to rtol 1e-9, in ORDER BY order (rows whose
         float sort keys agree within that may swap). Prints per query the
         median of 5 warm runs, the host syncs, the change in
         pipeline.stats (with the host ms in eager leaves and captures)
         and the group_agg launches of its first run. Each group_agg call
         of a first run outside a graph capture is held against the plain
         version on the same tensors (phase 1's tolerance); fails if
         group_agg launched in none of the queries or if Q6 did not run in
         the compiled pipeline. Then Q6 and Q14 with their dates a year
         later on the same Session must give the shifted oracle's rows.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after; a kernel of the path that was not launched fails the run.
A replayed CUDA graph runs no Python, so on the compiled paths the counts
move when the program first runs and when it is captured, and the
profiler's kernel names show what a replay ran.

The line before the last is one JSON object with the kernels' launches,
errors and times; the last line is {"ok": true, "device": {...}}. Any failed
check exits non-zero without those lines, and so does a machine without
CUDA or a directory without the package.
"""

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
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
# exactly and rescales, an error of at most ~n * max|x| * 2^-40 against the
# plain float64 index_add's own round-off — the bound of the JAX package's
# kernel tests (tests/test_pallas_kernels.py).
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
        if "registers" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")
    return card


def _items(rng, n, kinds, dev):
    import torch

    items = []
    for kind in kinds:
        ok = torch.from_numpy(rng.random(n) < 0.85).to(dev)
        if kind == "count_star":
            v = torch.ones(n, dtype=torch.int64, device=dev)
        elif kind == "i64":
            v = torch.from_numpy(rng.integers(50_000, 151_000, n)).to(dev)
        elif kind == "i64_wrap":
            v = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)
                                 + np.where(rng.random(n) < 0.5,
                                            (1 << 62) - 1, -(1 << 62))).to(dev)
        elif kind == "f64":
            v = torch.from_numpy(rng.normal(0.0, 1e7, n)).to(dev)
        else:  # f64 with +inf, -inf and NaN rows
            x = rng.normal(0.0, 1e3, n)
            x[rng.random(n) < 1e-4] = np.inf
            x[rng.random(n) < 1e-4] = -np.inf
            x[rng.random(n) < 1e-4] = np.nan
            v = torch.from_numpy(x).to(dev)
        items.append((v, ok))
    return items


def phase1():
    import torch

    from query_engine_tpu_torch.ops import group_agg

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    cases = [
        ("main path shape", 1 << 23, 2048, 1024, ["i64", "count_star"]),
        ("32768 groups", 1 << 23, 32768, 32768, ["i64", "f64"]),
        ("wrap-around", 1 << 20, 2048, 2048, ["i64_wrap"]),
        ("inf/-inf/NaN", 1 << 20, 2048, 2048, ["f64_ieee", "i64"]),
    ]
    max_err = 0.0
    times = {}
    for name, n, G, g_used, kinds in cases:
        gid_np = rng.integers(0, g_used, n).astype(np.int32)
        gid_np[rng.random(n) < 0.01] = -1  # excluded rows
        gid = torch.from_numpy(gid_np).to(dev)
        items = _items(rng, n, kinds, dev)
        got = group_agg.grouped_sums_counts_multi(items, gid, G)
        again = group_agg.grouped_sums_counts_multi(items, gid, G)
        want = group_agg.grouped_sums_counts_multi_plain(items, gid, G)
        torch.cuda.synchronize()
        for kind, (v, _), (s, c), (s2, c2), (ws, wc) in zip(
            kinds, items, got, again, want
        ):
            check(s.is_cuda and c.is_cuda, f"{name}: result not on the card")
            check(torch.equal(c, c2) and torch.equal(
                s.view(torch.int64), s2.view(torch.int64)),
                f"{name} {kind}: two kernel runs differ")
            check(torch.equal(c, wc), f"{name} {kind}: counts differ")
            if s.dtype == torch.int64:
                check(torch.equal(s, ws), f"{name} {kind}: int sums differ")
                continue
            a, b = s.cpu().numpy(), ws.cpu().numpy()
            x = v.cpu().numpy()
            finite_max = float(np.abs(x[np.isfinite(x)]).max())
            atol = finite_max * ATOL_PER_MAX
            close = np.isclose(a, b, rtol=RTOL, atol=atol, equal_nan=True)
            check(bool(close.all()),
                  f"{name} {kind}: {int((~close).sum())} float sums outside "
                  f"rtol {RTOL} atol {atol}")
            both = np.isfinite(a) & np.isfinite(b)
            if both.any():
                err = np.abs(a[both] - b[both]).max()
                max_err = max(max_err, float(err))
        print(f"phase 1: {name}: n={n} G={G} {kinds}: kernel == plain "
              "(ints exact, floats in tolerance), two runs bit-identical")
        if n == 1 << 23:
            k_ms = cuda_ms(lambda: group_agg.grouped_sums_counts_multi(
                items, gid, G))
            p_ms = cuda_ms(lambda: group_agg.grouped_sums_counts_multi_plain(
                items, gid, G))
            times[name] = (k_ms, p_ms)
            print(f"phase 1: {name}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms (mean of 20 after 3 warm-up, CUDA events)")
        if name == "main path shape":
            # the accumulate step alone, on already stacked int64 planes
            vals = torch.stack([v for v, _ in items])
            oks = torch.stack([ok for _, ok in items])
            k_acc = cuda_ms(lambda: group_agg.accumulate_kernel(
                gid, vals, oks, G))
            p_acc = cuda_ms(lambda: group_agg.accumulate_plain(
                gid, vals, oks, G))
            nbytes = gid.nbytes + vals.nbytes + oks.nbytes + 2 * 8 * 2 * G
            print(f"phase 1: {name}: accumulate only: kernel {k_acc:.4f} "
                  f"ms ({nbytes / k_acc / 1e6:.1f} GB/s of {nbytes} "
                  f"bytes), plain {p_acc:.4f} ms")
    return max_err, times


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


def profile_query(sess, query, tag):
    """One query under torch.profiler: prints the top of its table by CUDA
    time and returns the names of the CUDA kernels it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.sql(query).to_pylist()
        torch.cuda.synchronize()
    print(f"{tag}: profiled query, top operators by CUDA time:")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25))
    events = prof.events()
    names = {e.name for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return names | {k.name for e in events for k in getattr(e, "kernels", ())}


def profile_program(sess, tag):
    """Device time of the session's captured program by operator: its body
    run once eagerly (the same kernels a replay runs) under torch.profiler,
    where each operator's own kernels sit under its pipeline:<operator>
    range."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pipe = sess.executor.pipeline
    (entry,) = [e for e in pipe._cache.values() if e.graph is not None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe._body(entry, entry.planes, entry.n_bufs, entry.dyn_bufs)
        torch.cuda.synchronize()

    # a range appears twice: as a CPU event, whose device time is the sum
    # of the kernels launched inside it, and as a GPU annotation spanning
    # it on the device's timeline (gaps included); kernels are the rest
    events = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    total = sum(e.self_device_time_total for e in events
                if e.device_type == cuda and not e.key.startswith("pipeline:"))
    check(total > 0, f"{tag}: the profiler saw no device time")
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
                k in e.key for k in ("sum_count_", "gather_words")):
            print(f"  of which hand kernel {e.key[:40]}: "
                  f"{e.self_device_time_total / 1e3:.3f} ms")
    return total / 1e3


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


def phase3():
    import torch

    from query_engine_tpu_torch.ops import small_gather

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n = 1 << 23
    max_err = 0
    times = {}
    for T in (1024, 4096):
        for W in (1, 3):
            table = torch.from_numpy(rng.integers(
                -(2**31), 2**31, (T, W)).astype(np.int32)).to(dev)
            idx_np = rng.integers(0, T, n).astype(np.int32)
            idx_np[rng.random(n) < 0.05] = -1  # unmatched rows
            idx_np[rng.random(n) < 0.01] = T  # just past the table
            idx_np[:2] = [2**31 - 1, -(2**31)]
            idx = torch.from_numpy(idx_np).to(dev)
            got = small_gather.gather_words(idx, table)
            want = small_gather.gather_words_plain(idx, table)
            torch.cuda.synchronize()
            check(got.is_cuda and got.shape == (n, W),
                  f"small gather T={T} W={W}: bad result")
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs()
                      .max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"small gather T={T} W={W}: kernel != plain")
            k_ms = cuda_ms(lambda: small_gather.gather_words(idx, table))
            p_ms = cuda_ms(lambda: small_gather.gather_words_plain(idx,
                                                                   table))
            times[(T, W)] = (k_ms, p_ms)
            nbytes = n * 4 + n * W * 4 + T * W * 4
            print(f"phase 3: small gather n={n} T={T} W={W}: kernel == plain "
                  f"bit for bit; kernel {k_ms:.4f} ms "
                  f"({nbytes / k_ms / 1e6:.1f} GB/s of {nbytes} bytes), "
                  f"plain {p_ms:.4f} ms (mean of 20 after 3 warm-up, CUDA "
                  "events)")
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
    found = kernel_names(names, "sum_count_shared", "sum_count_global")
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
        check((launches["small_gather"] > 0) == (gate == "set"),
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
        profile_program(sess, f"phase 5: Query B ({gate})")
        found = kernel_names(names, "gather_words")
        check(bool(found) == (gate == "set"),
              f"Query B ({gate}): gather kernels in the replay: {found}")
        check(kernel_names(names, "sum_count_"),
              f"Query B ({gate}): no group_agg kernel in the replay")
        out[gate] = (ms, launches, found)
    os.environ.pop("QE_MXU_GATHER", None)
    print(f"phase 5: Query B gate unset {out['unset'][0]:.3f} ms vs set "
          f"{out['set'][0]:.3f} ms per query")
    return out


N_PROBE = 1 << 24
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
        v0_ms = cuda_ms(lambda: group_agg.grouped_sum_count(values, ok, gid,
                                                            G))
        u = torch.where(ok, values, 0)[None]
        v0_acc_ms = cuda_ms(lambda: group_agg.accumulate_kernel(
            gid_m, u, ok[None], G))
        print(f"phase 6: v0_production {v0_ms:.4f} ms, its accumulate "
              f"kernel alone {v0_acc_ms:.4f} ms")
        for v, f in entries.items():
            k_ms = cuda_ms(lambda: AV.chunk_totals_kernel(v, vlo, vhi, gid_m,
                                                          G))
            p_ms = cuda_ms(lambda: AV.chunk_totals_plain(v, vlo, vhi, gid_m,
                                                         G), iters=5)
            e_ms = cuda_ms(lambda: f(values, ok, gid))
            r = PV.kernel_rates(v, n, k_ms)
            times[v] = (k_ms, p_ms, e_ms, v0_ms, v0_acc_ms)
            print(f"phase 6: {v}: kernel {k_ms:.4f} ms ({r['rows_per_sec']:.4g}"
                  f" rows/s, {r['tc_tflops']:.2f} TFLOP/s on the tensor cores,"
                  f" {r['gb_per_sec']:.1f} GB/s of input), plain {p_ms:.4f} "
                  f"ms, entry point {e_ms:.4f} ms, v0 {v0_ms:.4f} ms "
                  "(CUDA events)")
    return main_launches, max_err, times


def _stats_change(before, after, skip=()):
    return {k: v - before[k] for k, v in after.items()
            if v != before[k] and k not in skip}


def device_ms(sess, query):
    """Kernel time on the card of one warm run of `query` (torch.profiler:
    the sum of the CUDA kernels' own time) and that run's wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.sql(query).to_pylist()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / 1e3
    return busy, wall


@contextlib.contextmanager
def group_agg_held_against_plain(calls):
    """While open, every call of `group_agg.grouped_sums_counts_multi` made
    on CUDA tensors outside a graph capture (the executor's, and a
    program's first run) is held against the plain version on the same
    tensors: counts and integer sums exactly, float sums within phase 1's
    tolerance. Appends one record per call to `calls`. The plain version
    launches no kernel, so the launch counts are the path's own."""
    import torch

    from query_engine_tpu_torch.ops import group_agg

    kernel = group_agg.grouped_sums_counts_multi

    def held(items, gid, num_groups):
        got = kernel(items, gid, num_groups)
        if not gid.is_cuda or torch.cuda.is_current_stream_capturing():
            return got
        want = group_agg.grouped_sums_counts_multi_plain(items, gid,
                                                         num_groups)
        shape = f"n={gid.numel()} G={num_groups} item"
        err, n_float = 0.0, 0
        for i, ((v, ok), (s, c), (ws, wc)) in enumerate(zip(items, got,
                                                            want)):
            check(torch.equal(c, wc), f"group_agg at {shape} {i}: counts "
                  "differ from the plain version")
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
                  f"atol {atol} of the plain version")
            both = torch.isfinite(s) & torch.isfinite(ws)
            if bool(both.any()):
                err = max(err, float((s - ws)[both].abs().max()))
        calls.append({"n": gid.numel(), "groups": num_groups,
                      "items": len(items), "float_items": n_float,
                      "columns": len(items) + 3 * n_float,
                      "max_abs_err": err})
        return got

    group_agg.grouped_sums_counts_multi = held
    try:
        yield
    finally:
        group_agg.grouped_sums_counts_multi = kernel


def phase7():
    """The twelve subquery-free TPC-H queries at scale factor 1 through
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
        held[q] = []
        reset_counts()
        with group_agg_held_against_plain(held[q]):
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
        check(len(rows) > 0, f"TPC-H {q} at SF1 returned no rows")
        walls, leaf_walls, capture_walls = [], [], []
        kinds0 = collections.Counter(pipe.leaf_kinds)
        st1, syncs1 = dict(pipe.stats), sess.executor.host_syncs
        for _ in range(5):
            before = dict(pipe.stats)
            t0 = time.perf_counter()
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
        busy, wall = device_ms(sess, text)
        out[q] = {"ms": ms, "first_ms": first_ms, "syncs": syncs,
                  "first_syncs": first_syncs, "first": first, "warm": warm,
                  "group_agg": launches, "max_rel_err": err,
                  "rows": len(rows), "eager_leaves": leaves,
                  "leaf_ms": leaf_ms, "capture_ms": capture_ms,
                  "device_ms": busy, "profiled_wall_ms": wall}
        print(f"phase 7: {q}: {len(rows)} rows == numpy oracle (max rel err "
              f"{err:.3g}, oracle {oracle_s:.2f} s); {ms:.3f} ms/query median "
              f"of 5 warm runs, {syncs:g} host syncs/query; first run "
              f"{first_ms:.1f} ms, {first_syncs} syncs, stats {first}; warm "
              f"stats per query {warm}; eager leaves {leaves} "
              f"{leaf_ms:.3f} ms/query, captures {capture_ms:.3f} ms/query "
              f"(host clock, medians of the same runs); group_agg launches "
              f"{launches}; one profiled "
              f"run: {busy:.3f} ms of kernel time in {wall:.3f} ms wall")
        for c in held[q]:
            print(f"phase 7: {q}: group_agg == plain on the same tensors: "
                  f"n={c['n']} G={c['groups']} {c['items']} items "
                  f"({c['float_items']} float, {c['columns']} kernel "
                  f"columns): counts and int sums exact, float sums within "
                  f"rtol {RTOL} atol max|x|*{ATOL_PER_MAX}, max abs err "
                  f"{c['max_abs_err']:.6g}")
    with_agg = [q for q, r in out.items() if r["group_agg"] > 0]
    check(with_agg, "group_agg launched in none of the TPC-H queries")
    for q in with_agg:
        check(held[q], f"TPC-H {q}: no group_agg call of its first run was "
              "held against the plain version")
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
    print(f"phase 7: the twelve queries: {total:.1f} ms in all (sum of the "
          f"medians); group_agg launched in {with_agg}")
    return out, held


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
    try:
        phase0()
        max_err, times = phase1()
        tables = make_tables(torch.device("cuda"))
        eager_ms = phase2(tables)
        g_err, g_times = phase3()
        agg_launches, agg_names = phase4(tables, eager_ms)
        b = phase5(tables)
        p6_launches, p6_err, p6_times = phase6()
        tpch, tpch_held = phase7()
    except CheckFailed as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    k_ms, p_ms = times["main path shape"]
    gk_ms, gp_ms = g_times[(1024, 1)]  # Query B's shape: 1024 rows, 1 word
    tpch_by_query = {q: r["group_agg"] for q, r in tpch.items()}
    tpch_launches = sum(tpch_by_query.values())
    tpch_err = max((c["max_abs_err"] for calls in tpch_held.values()
                    for c in calls), default=0.0)
    print(json.dumps({"kernels": [{
        "name": "group_sum_count_i64",
        "route": "cuda",
        "source": "query_engine_tpu_torch/csrc/group_agg.cu",
        "replaces": "query_engine_tpu/ops/pallas/group_agg.py:74",
        "launches": agg_launches + tpch_launches,
        "launches_by_phase": {"4": agg_launches, "7": tpch_by_query},
        "max_abs_err": max(max_err, tpch_err),
        "max_abs_err_by_phase": {"1": max_err, "7": tpch_err},
        "ms": k_ms,
        "plain_ms": p_ms,
        "in_replay": agg_names,
    }, {
        "name": "small_gather_u32",
        "route": "cuda",
        "source": "query_engine_tpu_torch/csrc/small_gather.cu",
        "replaces": "query_engine_tpu/ops/pallas/small_gather.py:40",
        "launches": b["set"][1]["small_gather"],
        "max_abs_err": g_err,
        "ms": gk_ms,
        "plain_ms": gp_ms,
        "in_replay": b["set"][2],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": p6_launches[f"onehot_{v}"],
        "max_abs_err": p6_err,
        "ms": p6_times[v][0],
        "plain_ms": p6_times[v][1],
        "entry_ms": p6_times[v][2],
        "v0_ms": p6_times[v][3],
    } for v, (name, source, replaces) in ONEHOT_KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
