"""Warm latency of the SF10 statements of `chip_smoke.py`'s phase 18, for
one checkout, on the card.

Builds the TPC-H tables at scale factor 10 (59,986,052 lineitem rows,
`tpch/data.generate`) in one Session(device="cuda") and runs phase 18's
statements in its order (the 22 queries, Q11 with TPC-H's FRACTION for
SF10, then tpch/scalar.py's F1 and F6): each a first run, then `--warm`
warm runs. Per statement it prints the first run's ms, the median, min
and max of the warm runs (host clock around `Session.sql(q).to_pylist()`),
and per warm run the host syncs, the captures, replays and graphs
released, and the host ms in eager leaves and in captures
(`pipeline.stats`). The rows are not checked: phase 18 holds them to the
numpy oracle.

    python scripts/sf10_warm.py
    python scripts/sf10_warm.py --root DIR --warm 5 --queries Q2 Q8 Q22

`--root` imports `query_engine_tpu_torch` from another checkout (e.g. an
earlier commit unpacked with `git archive`); `--queries` runs a subset,
still in phase 18's order. The last line is one JSON object with the
numbers by statement, the warm medians' sum and the card's name and
power limit. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

STATS = ("captures", "replays", "graphs_released", "oom_retries",
         "leaf_ms", "capture_ms")


def card_label():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--queries", nargs="+")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sf10_warm: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.tpch import data, queries, scalar

    statements = [(q, queries.Q11_SF10 if q == "Q11" else text)
                  for q, text in queries.QUERIES.items()]
    statements += [(q, scalar.QUERIES[q]) for q in ("F1", "F6")]
    if args.queries:
        statements = [(q, t) for q, t in statements if q in args.queries]
    card = card_label()
    tables = data.generate(data.SF10_LINEITEM)
    sess = Session(device="cuda")
    data.register(sess, tables)
    del tables
    ex = sess.executor
    pipe = ex.pipeline

    def run(text):
        t0 = time.perf_counter()
        sess.sql(text).to_pylist()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {}
    for q, text in statements:
        first_ms = run(text)
        st, syncs = dict(pipe.stats), ex.host_syncs
        walls = [run(text) for _ in range(args.warm)]
        per = {k: round((pipe.stats[k] - st[k]) / args.warm, 3)
               for k in STATS}
        r = out[q] = {"first_ms": round(first_ms, 3),
                      "ms": round(statistics.median(walls), 3),
                      "min_ms": round(min(walls), 3),
                      "max_ms": round(max(walls), 3),
                      "syncs": (ex.host_syncs - syncs) / args.warm,
                      "per_warm_run": per}
        print(f"{q}: first {r['first_ms']:.1f} ms; warm median "
              f"{r['ms']:.3f} ms ({r['min_ms']:.3f}-{r['max_ms']:.3f}) of "
              f"{args.warm}; {r['syncs']:g} host syncs, per warm run {per} "
              f"[{card}]", flush=True)
    total = sum(r["ms"] for r in out.values())
    print(json.dumps({"root": args.root, "warm": args.warm,
                      "sum_ms": round(total, 3), "statements": out,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
