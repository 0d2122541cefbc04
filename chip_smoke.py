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
Phase 2  runs the engine's main path through `Session(device="cuda").sql`
         at 2^23 - 17 fact rows and 1024 dimension rows, checks that it
         launched the kernel, and compares the 10 rows exactly with an
         independent numpy oracle. Prints ms per query, rows/s, the
         number of host syncs per query, and one profiled query's device
         time by operator (torch.profiler).

The line before the last is one JSON object with the kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}. Any failed
check exits non-zero without those lines, and so does a machine without
CUDA or a directory without the package.
"""

import json
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


def make_tables(dev):
    """The bench's fact and dimension tables from one seed."""
    from query_engine_tpu_torch.columnar.batch import padded_capacity
    from query_engine_tpu_torch.columnar.convert import from_numpy_batch
    from query_engine_tpu_torch.core.schema import Field
    from query_engine_tpu_torch.core.types import DataType

    rng = np.random.default_rng(SEED)
    n, cap = N_FACT, padded_capacity(N_FACT)
    cols = {
        "age": rng.integers(18, 65, n),
        "salary": rng.integers(50_000, 150_000, n),
        "dept": rng.integers(0, N_DIM, n),
    }
    bonus = rng.integers(0, 1000, N_DIM)
    valid = np.arange(cap) < n
    i64 = DataType.int64()

    def planes(arr):
        data = np.zeros(cap, dtype=np.int64)
        data[:n] = arr
        return data, valid, None

    fact = from_numpy_batch([Field(k, i64) for k in cols],
                            [planes(v) for v in cols.values()], n, dev)
    dcap = padded_capacity(N_DIM)
    dvalid = np.arange(dcap) < N_DIM

    def dplanes(arr):
        data = np.zeros(dcap, dtype=np.int64)
        data[:N_DIM] = arr
        return data, dvalid, None

    dim = from_numpy_batch(
        [Field("dept_id", i64), Field("bonus", i64)],
        [dplanes(np.arange(N_DIM)), dplanes(bonus)], N_DIM, dev)
    return cols, bonus, fact, dim


def oracle(cols, bonus):
    """numpy: mask, join by dept (dept_id = arange, so a lookup), bincount
    per dept, then a stable sort on -s over the groups in dept order."""
    m = cols["age"] > 25
    dept = cols["dept"][m]
    val = cols["salary"][m] + bonus[dept]
    c = np.bincount(dept, minlength=N_DIM)
    s = np.zeros(N_DIM, dtype=np.int64)
    np.add.at(s, dept, val)
    groups = np.nonzero(c)[0]
    order = groups[np.argsort(-s[groups], kind="stable")][:10]
    return [(int(g), int(c[g]), int(s[g])) for g in order]


def phase2():
    import torch

    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.ops import group_agg

    dev = torch.device("cuda")
    cols, bonus, fact, dim = make_tables(dev)
    sess = Session(device="cuda")
    sess.register_table("f", fact)
    sess.register_table("d", dim)
    sess.sql(QUERY).to_pylist()  # warm-up
    torch.cuda.synchronize()

    group_agg.launches = 0
    syncs0 = sess.executor.host_syncs
    out = sess.sql(QUERY)
    torch.cuda.synchronize()
    launches = group_agg.launches
    syncs = sess.executor.host_syncs - syncs0
    check(launches > 0, "the main path did not launch the group_agg kernel")
    for f, col in zip(out.schema, out.columns):
        check(col.data.is_cuda and col.validity.is_cuda,
              f"result column {f.name} is not a CUDA tensor")
    rows = out.to_pylist()
    want = oracle(cols, bonus)
    check(rows == want, f"main path rows differ from the oracle:\n{rows}\n"
                        f"{want}")
    print(f"phase 2: {QUERY}")
    print(f"phase 2: {len(rows)} rows == numpy oracle; first {rows[0]}")

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        sess.sql(QUERY).to_pylist()
        walls.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(walls)
    print(f"phase 2: {ms:.3f} ms/query median of 5 warm runs "
          f"(host clock, result on the host), {N_FACT / ms * 1e3:,.0f} "
          f"fact rows/s, {syncs} host syncs/query, kernel launches/query "
          f"{launches}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.sql(QUERY).to_pylist()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25))
    return launches


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
        launches = phase2()
    except CheckFailed as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    k_ms, p_ms = times["main path shape"]
    print(json.dumps({"kernels": [{
        "name": "group_sum_count_i64",
        "route": "cuda",
        "source": "query_engine_tpu_torch/csrc/group_agg.cu",
        "replaces": "query_engine_tpu/ops/pallas/group_agg.py:74",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
