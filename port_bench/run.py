"""Run one cell of the port's benchmark once, and print its result line.

    python3 -m port_bench.run --workload ssb-sf10.star --seed 7 \\
        --seconds 50 --trace 0

From the root of a checkout. The cell is an entry of `workloads` in
`BENCHMARK.json`; its configuration (`configs/<config>.json`) names the
generator and the reference, its traffic (`mixes/<traffic>.json`) the
statements, their order and the tables they read, and each per-layer metric
is read by `metrics/<metric>.py`. A run:

1. makes the tables on the card from `--seed` (`data/<family>.py`), copies
   them to the host for the reference, and registers them in one
   `Session(device="cuda")` of `query_engine_tpu_torch` (result cache off);
2. runs every statement of the mix once (its first run compiles and
   captures), which ends the set-up (`setup_s`: process start to the first
   timed statement, less the copy to the host, which only the reference
   needs);
3. measures for `--seconds`: one client in a closed loop runs the mix's
   statements in order, stream after stream, and stops at the end of the
   stream that passes `--seconds`; each statement is timed on the host
   clock from `sql()` to `to_pylist()` returning; with `--trace 1` under
   `torch.profiler`, and the per-layer metrics are read instead of the
   end-to-end ones;
4. frees the Session, runs the numpy reference (`reference/<family>.py`)
   once per statement of the window and compares every statement's rows
   with it (`reference/compare.py`), against the configuration's `limits`;
5. prints the numbers compared beside their limits as the last lines of
   standard error, and as the last line of standard output one JSON object:
   `correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
   `breakdown`, and last `checks`.

It exits non-zero and prints no result without CUDA (or with fewer cards
than the cell asks for), without the program, and if `jax`, `jaxlib`,
`flax` or `query_engine_tpu` was imported. The kernels build into
`query_engine_tpu_torch/_build/` and every other cache into
`.port_bench_cache/`, both inside the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".port_bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "query_engine_tpu")
GIB = float(1 << 30)
# the reference's statements run side by side: numpy lets go of the GIL in
# its long loops, and the card's machines have 8 cores or more
REFERENCE_THREADS = 4


def log(msg: str, card: str = "") -> None:
    print(f"[port_bench{' | ' + card if card else ''}] {msg}",
          file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str):
    """(cell, configuration, mix) of a workload of BENCHMARK.json."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    (cfg_entry,) = [c for c in spec["configs"] if c["name"] == cell["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    mix = load_json(BENCH / "mixes" / f"{cell['traffic']}.json")
    if mix["family"] != config["family"]:
        raise SystemExit(f"mix {cell['traffic']} is for {mix['family']}, "
                         f"configuration {cell['config']} for "
                         f"{config['family']}")
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise SystemExit(f"mix {cell['traffic']}: only one client in a "
                         "closed loop is built")
    return spec, cell, config, mix


def base_name(metric: str) -> str:
    """The quantity a metric's name measures: the part before its first dot
    (`geomean_ms.star` is `geomean_ms`, held in other cells to another
    bound)."""
    return metric.split(".")[0]


def reports(entry: dict, workload: str) -> bool:
    """Whether a cell reports a metric of BENCHMARK.json: its `workloads`
    name the cell, or it has none."""
    return workload in entry.get("workloads", [workload])


def per_layer_metrics(spec: dict, workload: str):
    """{name: (unit, reader module)} of the per-layer metrics this cell
    reports; a metric's reader is `metrics/<its base name>.py`."""
    return {m["name"]: (m["unit"], importlib.import_module(
                f"port_bench.metrics.{base_name(m['name'])}"))
            for m in spec["per_layer"] if reports(m, workload)}


def card_label(device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        line = smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        line = "nvidia-smi gave nothing"
    import torch

    return f"{torch.cuda.get_device_name(device)}; {line}"


def queries(config: dict, mix: dict) -> dict:
    """{statement name: SQL text} of the mix, from queries/<family>/."""
    family = config["family"]
    return {q: (BENCH / "queries" / family / f"{q}.sql").read_text()
            for q in dict.fromkeys(mix["statements"])}


def to_batch(table, device):
    """A generated table as the program's ColumnBatch: planes at a power of
    two capacity, the padding invalid."""
    import torch
    from query_engine_tpu_torch.columnar.batch import (
        Column, ColumnBatch, padded_capacity,
    )
    from query_engine_tpu_torch.columnar.dictionary import Dictionary
    from query_engine_tpu_torch.core.schema import Field, Schema
    from query_engine_tpu_torch.core.types import DataType

    types = {"int64": DataType.int64(), "float64": DataType.float64(),
             "date32": DataType.date32(), "utf8": DataType.utf8()}
    n = table.num_rows
    cap = padded_capacity(n)
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    valid[:n] = True
    fields, cols = [], []
    for c in table.columns:
        dt = types[c.kind]
        data = torch.zeros(cap, dtype=c.data.dtype, device=device)
        data[:n] = c.data
        dictionary = (Dictionary.from_sorted(c.dictionary)
                      if c.dictionary is not None else None)
        fields.append(Field(c.name, dt))
        cols.append(Column(data, valid.clone(), dt, dictionary))
    return ColumnBatch(Schema(fields), cols, n)


def check_sizes(config: dict, tables: dict) -> None:
    """The generated tables have the rows the configuration states (it
    holds no reference to a table after it returns: the generated tensors
    must go as they are registered)."""
    for name, rows in config["sizes"].items():
        if name in tables and tables[name].num_rows != rows:
            raise RuntimeError(f"{name}: {tables[name].num_rows} rows "
                               f"generated, {rows} configured")


def register(session, tables: dict, device) -> None:
    """Register each generated table with the Session, dropping the
    generated tensors as their planes are made."""
    for name in list(tables):
        session.register_table(name, to_batch(tables.pop(name), device))


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q of the
    values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(q * len(s)) - 1, 0)]


class Counters:
    """The program's own counters, read before and after the window."""

    def __init__(self, session):
        from query_engine_tpu_torch.ops import group_agg

        self.session, self.group_agg = session, group_agg
        self.before = self.read()

    def read(self) -> dict:
        ex = self.session.executor
        out = {f"pipeline.{k}": float(v) for k, v in ex.pipeline.stats.items()}
        out["executor.host_syncs"] = float(ex.host_syncs)
        out["group_agg.launches"] = float(self.group_agg.launches)
        return out

    def delta(self) -> dict:
        after = self.read()
        return {k: after[k] - self.before.get(k, 0.0) for k in after}


def run_cell(spec, cell, config, mix, seed: int, seconds: float,
             trace: bool, device="cuda", t0: float = T0, card: str = ""):
    """One run of a cell: the result line as a dict and the check lines."""
    import torch
    from query_engine_tpu_torch.engine.session import Session

    from port_bench.reference.compare import compare
    from port_bench import trace as tr

    device = torch.device(device)
    cuda = device.type == "cuda"
    texts = queries(config, mix)
    generator = importlib.import_module(config["generator"])
    reference = importlib.import_module(config["reference"])

    log(f"imports and the card's start-up: {time.perf_counter() - t0:.3f} s",
        card)
    t = time.perf_counter()
    tables = generator.generate(config, seed, device)
    tables = {k: tables[k] for k in mix.get("tables", tables)}
    check_sizes(config, tables)
    if cuda:
        torch.cuda.synchronize(device)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    host = {k: v.host() for k, v in tables.items()}
    copy_s = time.perf_counter() - t
    t = time.perf_counter()
    session = Session(device=device)
    register(session, tables, device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    reg_s = time.perf_counter() - t
    log(f"tables made in {gen_s:.3f} s, copied to the host in {copy_s:.3f} "
        f"s, registered in {reg_s:.3f} s", card)

    t = time.perf_counter()
    for q, text in texts.items():
        tq = time.perf_counter()
        session.sql(text).to_pylist()
        log(f"first run of {q}: {1e3 * (time.perf_counter() - tq):.1f} ms",
            card)
    warm_s = time.perf_counter() - t
    counters = Counters(session)
    # the copy to the host is the reference's, not the program's set-up
    setup_s = time.perf_counter() - t0 - copy_s
    log(f"set-up {setup_s:.3f} s (first runs {warm_s:.3f} s; the copy to "
        f"the host, {copy_s:.3f} s, left out)", card)
    prof = tr.start(cuda) if trace else None

    # Whole streams: the client runs the mix's statements in order, stream
    # after stream, and the window ends with the stream that passes
    # `seconds`, so every statement of the mix weighs alike in the rate,
    # the tail and the mean, wherever the clock stops.
    records = []   # (statement, ms, rows or None, parse + plan ms)
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        for q in mix["statements"]:
            with tr.span(prof, q):
                ts = time.perf_counter()
                try:
                    rows = session.sql(texts[q]).to_pylist()
                except Exception as e:  # counted as failed, not fatal
                    log(f"{q} failed: {type(e).__name__}: {e}", card)
                    rows = None
                ms = 1e3 * (time.perf_counter() - ts)
            timing = session.last_timing
            records.append((q, ms, rows, timing.parse_ms + timing.plan_ms))
    window_s = time.perf_counter() - start
    counts = counters.delta()
    trace_summary = tr.stop(prof) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log("latencies, ms: " + " ".join(f"{r[0]}:{r[1]:.1f}" for r in records),
        card)
    log(f"window closed: {len(records)} statements in {window_s:.3f} s; "
        "counters' change: " + ", ".join(
            f"{k} {v:g}" for k, v in counts.items() if v), card)

    # the program's state goes before the reference runs
    del session, counters
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    names = list(dict.fromkeys(r[0] for r in records))
    with ThreadPoolExecutor(REFERENCE_THREADS) as pool:
        want = dict(zip(names, pool.map(lambda q: reference.run(q, host),
                                         names)))
    ref_s = time.perf_counter() - t
    wrong, gap = 0, 0.0
    failed = 0
    per = {}    # statement: [runs, median ms, widest float gap]
    for q, ms, rows, _ in records:
        per.setdefault(q, [[], 0.0])[0].append(ms)
        if rows is None:
            failed += 1
            continue
        w, g = compare(rows, want[q], reference.ORDER[q])
        if w:
            log(f"{q}: rows differ from the reference", card)
        wrong += w
        failed += w
        gap = max(gap, g)
        per[q][1] = max(per[q][1], g)
    log(f"reference ran {len(want)} statements in {ref_s:.3f} s", card)
    log("by statement (runs, median ms, widest float gap): " + "; ".join(
        f"{q} {len(v[0])} {statistics.median(v[0]):.1f} {v[1]:.2e}"
        for q, v in per.items()), card)
    if trace_summary is not None:
        log("kernel ms by statement (runs, host ms, kernel ms): " + "; ".join(
            f"{q} {b['count']} {b['host_ms']:.1f} {b['kernel_ms']:.1f}"
            for q, b in trace_summary["by_statement"].items()), card)

    limits = config["limits"]
    # an unbounded gap (a float where the reference has 0) as the largest
    # float, so that the result line stays JSON
    readings = {"wrong": wrong,
                "float_gap": gap if math.isfinite(gap) else sys.float_info.max}
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = bool(records) and all(
        v["value"] <= v["limit"] for v in checks.values())

    lat = [r[1] for r in records]
    done = [r for r in records if r[2] is not None]
    # what a per-layer metric's reader may read
    ctx = {"config": config, "records": records, "statements": len(records),
           "counts": counts, "trace": trace_summary, "bench": BENCH,
           "device_name": torch.cuda.get_device_name(device) if cuda
           else "cpu"}
    if trace:
        metrics = {}
        for name, (unit, mod) in per_layer_metrics(spec,
                                                   cell["name"]).items():
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        values = {
            "queries_per_s": len(done) / window_s,
            "latency_p95_ms": percentile(lat, 0.95),
            "geomean_ms": math.exp(sum(math.log(x) for x in lat) / len(lat)),
            "peak_alloc_gib": peak / GIB,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[base_name(m["name"])],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"] if reports(m, cell["name"])}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": ctx["device_name"], "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_summary is not None:
        dev["busy_s"] = trace_summary["busy_s"]
        dev["window_s"] = trace_summary["window_s"]
        result["breakdown"] = trace_summary["breakdown"]
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in checks.items()]
    return result, lines


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec, cell, config, mix = cell_files(args.workload)
    if importlib.util.find_spec("query_engine_tpu_torch") is None:
        log("query_engine_tpu_torch, the program under test, is not here: "
            "run from the root of a checkout")
        return 4
    # every cache of a run inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    card = card_label(device)
    log(f"{args.workload}: seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}", card)
    result, lines = run_cell(spec, cell, config, mix, args.seed,
                             args.seconds, bool(args.trace), device,
                             card=card)
    found = forbidden_modules()
    if found:
        log(f"modules that must not be loaded were imported: {found}", card)
        return 3
    for line in lines:
        log(line, card)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
