"""The float error of TPC-H Q9 and F1 against the numpy oracle, for one
checkout, on the card.

Q9 sums `ep * (1 - d) - sc * qty` per (nation, year) and F1 (tpch/scalar.py)
computes CORR, REGR_SLOPE and the other statistics from one-pass sums of
x, x^2 and xy, whose subtraction multiplies the sums' relative error by
F1's cancellation factor. On the card every float SUM is a fixed-point sum
in the group_agg kernel, so these two show its error first. For each scale
factor (`--sf`, default 1 and 10: 6,001,215 and 59,986,052 lineitem rows,
`tpch/data.generate`) it builds the tables in one Session(device="cuda"),
runs each query once, holds its rows against the oracle at a loose
tolerance (1e-6, so that an error above rtol 1e-9 is measured, not
raised) and prints the largest relative error of each float column.

    python scripts/sum_precision.py
    python scripts/sum_precision.py --root DIR --sf 10

`--root` imports `query_engine_tpu_torch` from another checkout (e.g. an
earlier commit unpacked with `git archive`). The last line is one JSON
object with the errors by scale factor and query, and the card's name and
power limit. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

LINEITEM = {1: 6_001_215, 10: 59_986_052}  # TPC-H v3.0.1, 4.2.5
LOOSE = 1e-6  # row matching only; the errors are measured, not bounded
RTOL = 1e-9


def card_label():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--sf", type=int, nargs="+", default=[1, 10],
                    choices=sorted(LINEITEM))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sum_precision: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from query_engine_tpu_torch.engine.session import Session
    from query_engine_tpu_torch.tpch import data, oracle, queries, scalar

    card = card_label()
    print(card)
    report = {"root": args.root, "card": card, "errors": {}}
    for sf in args.sf:
        t0 = time.perf_counter()
        tables = data.generate(LINEITEM[sf])
        sess = Session(device="cuda")
        data.register(sess, tables)
        setup_s = time.perf_counter() - t0
        runs = {
            "Q9": (queries.QUERIES["Q9"], oracle.run("Q9", tables),
                   oracle.FLOAT_SORT_KEYS.get("Q9", ())),
            "F1": (scalar.QUERIES["F1"], scalar.run("F1", tables), ()),
        }
        for q, (text, want, keys) in runs.items():
            rows = sess.sql(text).to_pylist()
            oracle.compare(rows, want, keys, rtol=LOOSE)
            cols = scalar.float_errors(rows, want)
            worst = max(cols.values(), default=0.0)
            report["errors"].setdefault(f"SF{sf}", {})[q] = {
                "max_rel_err": worst, "by_column": cols,
                "share_of_rtol": worst / RTOL}
            print(f"SF{sf} {q}: {len(rows)} rows; largest relative error "
                  f"{worst:.6g} ({100 * worst / RTOL:.3g} % of rtol {RTOL}); "
                  f"by float column {cols} (tables built in {setup_s:.1f} s)"
                  f" [{card}]")
        del sess, tables
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
